"""The synthetic corpus is a function of the seed, with the same sizes for
every seed."""
import numpy as np

from portbench.traffic import corpus


def test_same_seed_same_signals_other_seed_other_signals():
    a = corpus.make_split(123456789012, "Train", 5, (1.3, 1.6), True, "cpu")
    b = corpus.make_split(123456789012, "Train", 5, (1.3, 1.6), True, "cpu")
    c = corpus.make_split(7, "Train", 5, (1.3, 1.6), True, "cpu")
    for k in ("clean", "noise", "multi_enh"):
        assert np.array_equal(a[k], b[k])
    assert a["names"] == b["names"]
    assert not np.array_equal(a["clean"], c["clean"])


def test_every_seed_gets_the_same_sizes():
    d1, d2 = corpus.deal(1, 40, (1.5, 3.0)), corpus.deal(2, 40, (1.5, 3.0))
    assert sorted(d1["lens"]) == sorted(d2["lens"])
    assert sorted(d1["kinds"]) == sorted(d2["kinds"])
    assert sorted(d1["snrs"]) == sorted(d2["snrs"])
    assert list(d1["lens"]) != list(d2["lens"])


def test_written_files_read_back(tmp_path):
    dirs = corpus.write_corpus(str(tmp_path), 3, 3, 2, (1.3, 1.4), "cpu")
    names = corpus.names_of(dirs["train_clean"])
    assert len(names) == 3 and corpus.names_of(dirs["test_noise"])
    x = corpus.read_pcm(f"{dirs['train_multi_enh']}/{names[0]}")
    assert x.dtype == np.float32 and 1.3 * 16000 - 1 <= len(x) <= 1.4 * 16001

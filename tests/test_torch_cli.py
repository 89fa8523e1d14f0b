"""The port's CLIs and its reader of the JAX package's checkpoints, against
the JAX package's own CLIs on one small config and one JAX checkpoint."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch
from flax import serialization

from nelegan_tpu.cli import collect_norm as jcollect
from nelegan_tpu.cli import eval_reverb as jeval
from nelegan_tpu.cli import export_torch as jexport
from nelegan_tpu.cli import infer as jinfer
from nelegan_tpu.config import Config as JaxConfig
from nelegan_tpu.config import config_to_dict as jax_config_to_dict
from nelegan_tpu.train import gan as jgan
from nelegan_tpu.train.checkpoint import save_checkpoint as jax_save
from nelegan_tpu_torch.cli import (collect_norm, eval_reverb, export_torch,
                                   infer, serve, stream, train)
from nelegan_tpu_torch.config import Config, ModelConfig, TrainConfig
from nelegan_tpu_torch.models.convert import (reference_state_dicts,
                                              train_state_from_jax)
from nelegan_tpu_torch.train import checkpoint as ckpt
from nelegan_tpu_torch.train import flax_msgpack, gan
from nelegan_tpu_torch.train.loop import Trainer, TrainPaths

CFG = dataclasses.replace(Config(), model=ModelConfig(
    gen_hidden=16, gen_blocks=3, disc_channels=(4, 8), disc_kernels=(1, 3)))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's `init_train_state`, jitted, for this module and the
    JAX CLIs it calls: one compilation in place of ~14 s of op-by-op
    compilation on the CPU.  The CLIs restore every leaf of their template
    state from the checkpoint, so what they write does not change."""
    jitted = jax.jit(jgan.init_train_state, static_argnums=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgan, "init_train_state",
                   lambda key, cfg=JaxConfig(): jitted(key, cfg))
        yield jgan.init_train_state


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory, jax_init):
    """A JAX TrainState of the small config, its Adam moments and counters
    drawn from a seed (a fresh state's are zeros), saved by the JAX
    package; -> (checkpoint directory, the state as numpy leaves)."""
    jcfg = dataclasses.replace(JaxConfig(), model=dataclasses.replace(
        JaxConfig().model, gen_hidden=16, gen_blocks=3, disc_channels=(4, 8),
        disc_kernels=(1, 3)))
    state = jax_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1)

    def draw(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return np.asarray(rng.randint(1, 9), np.int32).reshape(x.shape)
        return rng.uniform(0.01, 0.1, x.shape).astype(x.dtype)

    state = state._replace(
        **{k: jax.tree.map(draw, getattr(state, k))
           for k in ("gen_opt", "d_opt", "dq_opt", "step_g", "step_d")})
    d = tmp_path_factory.mktemp("jax_ckpt")
    jax_save(str(d), 3, state, jax.random.PRNGKey(5),
             extra={"config": jax_config_to_dict(jcfg)})
    return str(d), jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, goldens):
    """Four pairs of one length bucket (one JAX compilation), PCM16, from
    the golden signals."""
    root = tmp_path_factory.mktemp("corpus")
    g = goldens("features")
    for sub in ("Clean", "Noise"):
        (root / sub).mkdir()
    for i, n in enumerate([5000, 6001, 7000, 8192]):
        o = 1000 * i
        name = f"utt{i}#Cafeteria#{i}.wav"
        wavfile.write(root / "Clean" / name, 16000,
                      (g["clean"][o:o + n] * 32768).astype(np.int16))
        wavfile.write(root / "Noise" / name, 16000,
                      (g["noise"][o:o + n] * 32768).astype(np.int16))
    return root


def _state_dicts_equal(a, b):
    def walk(x, y, key):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), key
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), key
            for k in x:
                walk(x[k], y[k], f"{key}.{k}")
        else:
            assert x == y, key
    walk(a, b, "state")


def test_msgpack_checkpoint_loads_like_train_state_from_jax(jax_ckpt):
    path, jstate = jax_ckpt
    assert ckpt.config_for_checkpoint(path) == CFG
    assert ckpt.peek_meta(path)["epoch"] == 3
    loaded, rng, epoch, replay = ckpt.load_checkpoint(
        path, gan.init_train_state(CFG, 9, "cpu"))
    want = train_state_from_jax(jstate, CFG, "cpu")
    _state_dicts_equal(loaded.state_dict(), want.state_dict())
    assert loaded.step_g == int(jstate.step_g) and epoch == 3
    assert loaded.gen_opt.state_dict()["state"][0]["step"] == float(
        jstate.gen_opt[0].count)
    assert rng.dtype == np.uint32 and rng.tolist() == np.asarray(
        jax.random.key_data(jax.random.PRNGKey(5))).tolist()
    assert replay == "[]"


def test_msgpack_decoder_matches_flax(jax_ckpt, monkeypatch):
    path, _ = jax_ckpt
    blob = open(os.path.join(path, "chkpt_3.msgpack"), "rb").read()
    want = serialization.msgpack_restore(blob)
    got = flax_msgpack.restore(blob)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # scalars, complex numbers, nil, bools, strings, nested maps, and an
    # array chunked as flax chunks leaves over its limit
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"f": np.float32(1.5), "i": np.int64(-7), "c": complex(1.0, -2.5),
            "n": None, "b": [True, False], "s": "x" * 40,
            "big": np.arange(100, dtype=np.float64).reshape(4, 25),
            "nested": {"k": -3, "u": 2 ** 40, "h": 0.25, "e": {}}}
    got = flax_msgpack.restore(serialization.msgpack_serialize(tree))
    assert got["big"].shape == (4, 25) and np.array_equal(got["big"],
                                                          tree["big"])
    assert got["f"] == 1.5 and got["f"].dtype == np.float32
    assert got["c"] == complex(1.0, -2.5) and got["i"] == -7
    assert got["n"] is None and got["b"] == [True, False]
    assert got["s"] == tree["s"] and got["nested"] == tree["nested"]
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(blob[:-3])


def test_infer_cli_matches_jax(jax_ckpt, corpus, tmp_path, capsys):
    path, _ = jax_ckpt
    args = ["--test-clean", str(corpus / "Clean"), "--test-noise",
            str(corpus / "Noise"), "--checkpoint", path, "--batch-size", "4",
            "--metrics", ""]
    jinfer.main(args + ["--output", str(tmp_path / "jax")])
    res = infer.main(args + ["--output", str(tmp_path / "port"),
                             "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 4 and names == sorted(os.listdir(tmp_path / "port"))
    assert sorted(os.path.basename(p) for p in res["written"]) == names
    n_diff = n_total = 0
    for name in names:
        assert name.endswith("@1.wav")
        rate, want = wavfile.read(tmp_path / "jax" / name)
        _, got = wavfile.read(tmp_path / "port" / name)
        n = len(wavfile.read(corpus / "Clean" / name.replace("@1", ""))[1])
        assert rate == 16000 and got.shape == want.shape == (256 * (n // 256),)
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, name
        n_diff += int((d > 0).sum())
        n_total += d.size
    print(f"PCM16 samples differing from the JAX CLI: {n_diff} of {n_total}")
    # PESQ and ViSQOL, refused before they were ported, now score; the
    # default is all five metrics, as in the JAX CLI
    assert infer.build_parser().parse_args(args[:4]).metrics == (
        jinfer.build_parser().parse_args(args[:4]).metrics)
    res = infer.main(args[:-1] + ["pesq,visqol", "--subsets", "utt0#",
                                  "--output", str(tmp_path / "x"),
                                  "--device", "cpu"])
    means = res["scores"]["utt0#"]["means"]
    assert set(means) == {"pesq", "visqol"}
    assert all(np.isfinite(v) for v in means.values())
    with pytest.raises(SystemExit, match="unknown metric"):
        infer.main(args[:-1] + ["pesq,bogus", "--output", str(tmp_path / "y"),
                                "--device", "cpu"])


def _printed_means(text: str, subset: str) -> dict:
    lines = text.splitlines()
    line = lines[lines.index(f"{subset}:") + 1]
    return {kv.split(" is ")[0].strip().lower(): float(kv.split(" is ")[1])
            for kv in line.split(",")}


def test_infer_cli_scores_like_jax(jax_ckpt, corpus, tmp_path, capsys):
    """`--metrics siib,haspi,estoi,pesq,visqol` prints the JAX CLI's
    per-subset means.  The subset is one utterance (the JAX package compiles
    each metric once per distinct length); both CLIs score the float32 wavs
    they wrote, and print three decimals, so the bar is the print's last
    digit, 1e-3."""
    path, _ = jax_ckpt
    subset = "utt1#"
    args = ["--test-clean", str(corpus / "Clean"), "--test-noise",
            str(corpus / "Noise"), "--checkpoint", path, "--batch-size", "4",
            "--metrics", "siib,haspi,estoi,pesq,visqol", "--subsets", subset]
    jinfer.main(args + ["--output", str(tmp_path / "jax")])
    want = _printed_means(capsys.readouterr().out, subset)
    res = infer.main(args + ["--output", str(tmp_path / "port"),
                             "--device", "cpu"])
    got = _printed_means(capsys.readouterr().out, subset)
    assert want.keys() == got.keys() == {"siib", "haspi", "estoi", "pesq",
                                         "visqol"}
    for m in want:
        assert abs(got[m] - want[m]) <= 1e-3 + 1e-9, (m, got, want)
    scored = res["scores"][subset]
    assert scored["names"] == ["utt1#Cafeteria#1@1.wav"]
    for m in want:
        assert abs(round(scored["means"][m], 3) - got[m]) < 1e-9


def _printed_values(text: str, metric: str) -> list:
    tag = f"{metric.upper()} is "
    return [float(part.split(tag)[1]) for line in text.splitlines()
            for part in line.split(",") if tag in part]


def test_eval_reverb_cli_matches_jax(jax_ckpt, corpus, tmp_path, capsys):
    """One utterance without reverb and through a synthetic RIR (a direct
    path and a decaying tail, tests/test_cli_eval.py's), --metrics estoi:
    the printed means equal the JAX CLI's to the print's last digit."""
    path, _ = jax_ckpt
    rir = np.zeros(2000, np.float32)
    rir[40] = 1.0
    rir[200:1200] = 0.2 * np.exp(-np.arange(1000) / 200.0)
    rir_path = str(tmp_path / "rir.wav")
    wavfile.write(rir_path, 16000, (rir * 32767).astype(np.int16))
    args = ["--test-clean", str(corpus / "Clean"), "--test-noise",
            str(corpus / "Noise"), "--checkpoint", path, "--num-utts", "1",
            "--batch-size", "1", "--metrics", "estoi", "--rir", "NO_rev",
            "--rir", rir_path]
    jeval.main(args)
    want = _printed_values(capsys.readouterr().out, "estoi")
    res = eval_reverb.main(args + ["--device", "cpu"])
    got = _printed_values(capsys.readouterr().out, "estoi")
    assert len(want) == len(got) == 2 and list(res) == ["NO_rev", rir_path]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 + 1e-9, (got, want)


def test_collect_norm_cli_matches_jax(corpus, tmp_path):
    """One utterance, --metrics estoi, with an RIR directory (the clean
    name's #Cafeteria# field names the RIR): the four saved distributions,
    calibrated and raw, equal the JAX CLI's within 1e-5 (float32 signals,
    each package's FFT convolution for the reverberation)."""
    enh, rirs = tmp_path / "Enh", tmp_path / "RIR"
    enh.mkdir()
    rirs.mkdir()
    for name in os.listdir(corpus / "Clean"):
        _, x = wavfile.read(corpus / "Clean" / name)
        wavfile.write(enh / name, 16000, (0.8 * x).astype(np.int16))
    rir = np.zeros(1200, np.float32)
    rir[30] = 1.0
    rir[100:1100] = 0.1 * np.exp(-np.arange(1000) / 150.0)
    wavfile.write(rirs / "Cafeteria.wav", 16000,
                  (rir * 32767).astype(np.int16))
    for raw in ([], ["--raw"]):
        args = ["--clean", str(corpus / "Clean"), "--noise",
                str(corpus / "Noise"), "--enhanced", str(enh), "--rir-dir",
                str(rirs), "--num", "1", "--metrics", "estoi"] + raw
        jcollect.main(args + ["--out", str(tmp_path / "jax")])
        acc = collect_norm.main(args + ["--out", str(tmp_path / "port"),
                                        "--device", "cpu"])
        conds = ("before", "after", "rev_before", "rev_after")
        assert set(acc) == {("estoi", c) for c in conds}
        for c in conds:
            want = np.load(tmp_path / "jax" / f"estoi_{c}.npy")
            got = np.load(tmp_path / "port" / f"estoi_{c}.npy")
            assert got.shape == want.shape == (1,)
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=c)


def test_stream_cli_runs(jax_ckpt, corpus, tmp_path):
    path, _ = jax_ckpt
    out = tmp_path / "enh.wav"
    name = "utt3#Cafeteria#3.wav"
    res = stream.main(["--clean", str(corpus / "Clean" / name), "--noise",
                       str(corpus / "Noise" / name), "--out", str(out),
                       "--checkpoint", path, "--chunk-ms", "64",
                       "--compare-offline", "--device", "cpu"])
    rate, wav = wavfile.read(out)
    assert rate == 16000 and wav.shape == (256 * (8192 // 256),)
    assert res["samples"] == wav.size and res["rtf"] > 0
    assert res["offline_max_dev"] < 1e-5          # float32 offline parity


def test_export_torch_matches_jax(jax_ckpt, tmp_path):
    """The generator-only export equals the JAX package's; the full one
    holds the three models as the checkpoint has them (the JAX exporter
    takes only the reference's five-layer discriminators)."""
    path, jstate = jax_ckpt
    jexport.main(["--checkpoint", path, "--out", str(tmp_path / "j.pt"),
                  "--generator-only"])
    export_torch.main(["--checkpoint", path, "--out", str(tmp_path / "g.pt"),
                       "--device", "cpu", "--generator-only"])
    want = torch.load(tmp_path / "j.pt", weights_only=True)
    got = torch.load(tmp_path / "g.pt", weights_only=True)
    assert list(got) == list(want) == ["enhance-model"]
    _state_dicts_equal(got, want)
    export_torch.main(["--checkpoint", path, "--out", str(tmp_path / "t.pt"),
                       "--device", "cpu"])
    full = reference_state_dicts(str(tmp_path / "t.pt"))
    state = train_state_from_jax(jstate, CFG, "cpu")
    _state_dicts_equal(full, {k: getattr(state, k).state_dict()
                              for k in ("gen", "d", "dq")})


def test_serve_checkpoint_loads_the_same_generator(jax_ckpt, tmp_path,
                                                   monkeypatch):
    path, jstate = jax_ckpt
    seen = {}

    class Server:
        def __init__(self, generator, **kw):
            seen.update(kw, generator=generator)

        def warmup(self, lengths):
            pass

        def serve(self, host, port):
            pass

        def stop(self):
            pass

    monkeypatch.setattr(serve, "EnhanceServer", Server)
    serve.main(["--checkpoint", path, "--warmup-lengths", "",
                "--device", "cpu"])
    want = train_state_from_jax(jstate, CFG, "cpu").gen.state_dict()
    _state_dicts_equal(seen["generator"].state_dict(), want)
    assert seen["cfg"] == CFG and len(seen["generator"].convolutions) == 3
    # --torch-checkpoint wins over --checkpoint, as in the JAX server
    other = gan.init_train_state(CFG, 4, "cpu").gen.state_dict()
    ref = str(tmp_path / "chkpt_GD.pt")
    torch.save({"enhance-model": other}, ref)
    serve.main(["--checkpoint", path, "--torch-checkpoint", ref,
                "--warmup-lengths", "", "--device", "cpu"])
    _state_dicts_equal(seen["generator"].state_dict(), other)


def test_train_cli_equals_its_trainer(corpus, tmp_path):
    """`cli/train --device cpu` for one epoch at the default (full-width)
    model equals, bit for bit, a Trainer built with the config the CLI
    builds; `--resume` runs epoch 2 from its checkpoint; with `--compute-dtype
    bfloat16` it trains an epoch, its parameters float32 and finite.  The
    corpus serves as training and test set."""
    def args(run):
        return ["--train-clean", str(corpus / "Clean"), "--train-noise",
                str(corpus / "Noise"), "--test-clean", str(corpus / "Clean"),
                "--test-noise", str(corpus / "Noise"), "--num-sampling", "4",
                "--num-valid", "1", "--batch-size", "4", "--metrics",
                "pesq", "--output", str(run / "out"), "--checkpoints",
                str(run / "chkpt"), "--log-file", str(run / "log.txt"),
                "--device", "cpu"]

    t = train.main(args(tmp_path / "cli") + ["--epochs", "1"])
    cfg = Config(train=TrainConfig(gan_epochs=1, num_sampling=4, num_valid=1,
                                   batch_size=4))
    run = tmp_path / "ref"
    ref = Trainer(TrainPaths(
        train_clean=str(corpus / "Clean"), train_noise=str(corpus / "Noise"),
        test_clean=str(corpus / "Clean"), test_noise=str(corpus / "Noise"),
        output=str(run / "out"), checkpoints=str(run / "chkpt"),
        log_file=str(run / "log.txt")), cfg, metric_set=("pesq",),
        device="cpu")
    ref.run(1)
    assert t.cfg == ref.cfg and t.metric_set == ("pesq",)
    _state_dicts_equal(t.state.state_dict(), ref.state.state_dict())
    assert [e.scores for e in t.replay.entries] == \
        [e.scores for e in ref.replay.entries]
    assert open(t.paths.log_file).read() == open(ref.paths.log_file).read()

    resumed = train.main(args(tmp_path / "cli") + ["--epochs", "2",
                                                   "--resume"])
    assert resumed.state.step_g == 1 and len(resumed.history["pesq"]) == 2
    bf16 = train.main(args(tmp_path / "bf16") + ["--compute-dtype",
                                                 "bfloat16", "--epochs", "1"])
    assert bf16.cfg.model.compute_dtype == "bfloat16"
    assert bf16.state.gen.compute_dtype is torch.bfloat16
    assert (bf16.state.step_g, bf16.state.step_d) == (0, ref.state.step_d)
    assert len(bf16.history["pesq"]) == 1
    for m in ("gen", "d", "dq"):
        for v in getattr(bf16.state, m).state_dict().values():
            assert v.dtype == torch.float32 and torch.isfinite(v).all()

"""The port's training report (`cli/train_report.py`), CPU: one epoch of
one seed of `b8_f32` on the smallest synthetic corpus that
`tools/make_synth_corpus.py` builds (two training and one test
utterance): the JSON's schema and the markdown table, the gain arithmetic
against a hand computation, the band column against the JAX package's
`multiseed.json`, and the skip of a recorded seed."""
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nelegan_tpu_torch.cli import train_report

REPO = Path(__file__).resolve().parents[1]
METRICS = ("siib", "haspi", "estoi", "pesq", "visqol")
ROW = re.compile(r"^\| (\w+) \| (.+) \|$")


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """One run of the report -> (argv, results, out dir, work dir)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("report")
    argv = ["--seeds", "101", "--epochs", "1", "--variants", "b8_f32",
            "--n-train", "2", "--n-test", "1", "--n-valid", "1",
            "--work", str(tmp / "work"), "--out", str(tmp / "out"),
            "--device", "cpu"]
    try:
        results = train_report.main(argv)
    finally:
        torch.set_num_threads(n)
    return argv, results, tmp / "out", tmp / "work"


def table(md: str, variant: str) -> dict:
    """metric -> the cells of its row in `variant`'s table."""
    section = md.split(f"## {variant} ", 1)[1].split("\n## ", 1)[0]
    rows = {}
    for line in section.splitlines():
        m = ROW.match(line)
        if m and m.group(1) in METRICS:
            rows[m.group(1)] = [c.strip() for c in m.group(2).split("|")]
    return rows


def test_json_schema_and_table(campaign):
    _, results, out, _ = campaign
    with open(out / "multiseed.json") as f:
        assert json.load(f) == json.loads(json.dumps(results))
    assert (results["epochs"], results["n_sampling"], results["n_valid"]) \
        == (1, 2, 1)
    (run,) = results["variants"]["b8_f32"]
    assert run["seed"] == 101 and run["device"] == "cpu"
    for key in ("baseline", "best", "best_epoch", "history"):
        assert set(run[key]) == set(METRICS), key
    assert all(len(v) == 1 for v in run["history"].values())
    assert {"validate", "enhance_for_d", "score_for_d", "score_drc",
            "d_train", "checkpoint"} <= set(run["timing"])
    assert run["wall_s"] > 0 and run["epochs_this_call"] == 1
    # the generator takes no step in epoch 1: its validation is the
    # untrained baseline's, bit for bit
    assert run["best"] == run["baseline"]
    assert run["best_epoch"] == {m: 1 for m in METRICS}
    rows = table((out / "MULTISEED.md").read_text(), "b8_f32")
    assert list(rows) == list(METRICS)
    assert all(len(cells) == 6 for cells in rows.values())
    for m, cells in rows.items():
        assert float(cells[0]) == pytest.approx(run["baseline"][m], abs=1e-4)


def test_corpus_is_the_jax_reports(campaign, tmp_path):
    """The corpus is the one tools/make_synth_corpus.py writes, byte for
    byte."""
    _, _, _, work = campaign
    spec = importlib.util.spec_from_file_location(
        "make_synth_corpus", REPO / "tools" / "make_synth_corpus.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main([str(tmp_path), "--n-train", "2", "--n-test", "1",
               "--seed", "1234"])
    built = work / "corpus_2_1"
    files = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*.wav"))
    assert len(files) == 8
    for rel in files:
        assert (built / rel).read_bytes() == (tmp_path / rel).read_bytes()


def test_gain_arithmetic_and_band_column(tmp_path):
    """Two made-up runs against a hand computation; the band column
    against the JAX package's multiseed.json."""
    runs = [{"seed": s, "device": "cpu", "s_per_epoch": 1.0,
             "timing": {"validate": {"mean_s": 0.5}},
             "baseline": {m: b for m in METRICS},
             "best": {m: b * f for m in METRICS}}
            for s, b, f in ((1, 2.0, 1.5), (2, -4.0, 0.5))]
    # gains 100 (3 - 2) / 2 = +50 and 100 (-2 + 4) / 4 = +50; ViSQOL's
    # spread is 0 too
    results = {"epochs": 1, "n_sampling": 2, "n_valid": 1,
               "variants": {"b8_f32": runs, "b64_bf16": runs}}
    bands = train_report.jax_bands()
    md = tmp_path / "MULTISEED.md"
    train_report.render_md(results, str(md), bands)
    with open(REPO / "artifacts" / "train_report" / "multiseed.json") as f:
        jax_runs = json.load(f)["variants"]
    for variant in ("b8_f32", "b64_bf16"):
        rows = table(md.read_text(), variant)
        for m in METRICS:
            base = np.array([r["baseline"][m] for r in jax_runs[variant]])
            best = np.array([r["best"][m] for r in jax_runs[variant]])
            g = 100 * (best - base) / np.abs(base)
            lo, hi = g.mean() - 2 * g.std(), g.mean() + 2 * g.std()
            cells = rows[m]
            assert cells[0] == "-1.0000"                # mean baseline
            assert cells[1] == "0.5000 +/- 2.5000"     # bests 3 and -2
            assert cells[2] == "+50.0 +/- 0.0" and cells[3] == "+50.0"
            assert cells[4] == f"{lo:+.1f} to {hi:+.1f}"
            assert cells[5] == ("yes" if lo <= 50.0 <= hi else "no")
    # the JAX campaign's SIIB gain for b8_f32, +67.4 +/- 6.8 % (its
    # MULTISEED.md), as a band
    assert bands["b8_f32"]["siib"][0] == pytest.approx(
        67.4 - 2 * 6.8, abs=0.1)


def test_recorded_seed_is_skipped(campaign, capsys, monkeypatch):
    argv, results, out, _ = campaign

    def train(*args, **kw):
        raise AssertionError("a recorded seed trained again")

    monkeypatch.setattr(train_report, "run_one", train)
    before = (out / "multiseed.json").read_text()
    again = train_report.main(argv)
    said = capsys.readouterr().out
    assert "[skip] b8_f32 seed 101 (already recorded)" in said
    assert json.loads(json.dumps(again)) == json.loads(before)


def untrained_baselines(corpus: str, seeds, work: str) -> dict:
    """Each package's `validate(epoch=0)` of its untrained generator on the
    CPU (float32), at the report's `b8_f32` configuration and 16
    validated utterances of `corpus` -> {package: {seed: scores}}."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from nelegan_tpu import config as jconfig
    from nelegan_tpu.train import loop as jloop
    from nelegan_tpu_torch import config as tconfig
    from nelegan_tpu_torch.train import loop as tloop

    out = {}
    for name, cfgs, loop, kw in (("jax", jconfig, jloop, {}),
                                 ("torch", tconfig, tloop,
                                  {"device": "cpu"})):
        out[name] = {}
        for seed in seeds:
            cfg = cfgs.Config(train=cfgs.TrainConfig(
                num_sampling=300, num_valid=16, batch_size=8, seed=seed))
            run = f"{work}/{name}_{seed}"
            paths = loop.TrainPaths(
                *(f"{corpus}/{s}" for s in ("Train/Clean", "Train/Noise",
                                            "Test/Clean", "Test/Noise")),
                train_enhanced=f"{corpus}/Train/MultiEnh",
                output=f"{run}/output", checkpoints=f"{run}/chkpt",
                log_file=f"{run}/log.txt")
            t = loop.Trainer(paths, cfg, metric_set=METRICS,
                             valid_metric_set=METRICS, **kw)
            out[name][seed] = t.validate(epoch=0)
            print(name, seed, out[name][seed], flush=True)
    return out


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_train_report.py CORPUS WORK
    # [SEEDS], from the repository's root: the untrained baselines of both
    # packages on the CPU, beside the JAX campaign's
    # (artifacts/train_report/multiseed.json); CORPUS is the report's
    # (tools/make_synth_corpus.py CORPUS --n-train 300 --n-test 16 --seed
    # 1234)
    import sys
    seeds = [int(s) for s in (sys.argv[3] if len(sys.argv) > 3
                              else "101,202,303").split(",")]
    got = untrained_baselines(sys.argv[1], seeds, sys.argv[2])
    with open(REPO / "artifacts" / "train_report" / "multiseed.json") as f:
        campaign = {r["seed"]: r["baseline"]
                    for r in json.load(f)["variants"]["b8_f32"]}
    got["jax_campaign"] = {s: campaign[s] for s in seeds if s in campaign}
    print(json.dumps(got))

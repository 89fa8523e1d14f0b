"""The result line, the checks and the harness's discovery by name."""
import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ENHANCE_SHRINK, ROOT
from portbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_line_keys_untraced_and_traced():
    harness.set_environment()
    r = harness.run_cell("enhance.f32.b64", 3, 0.2, False, device="cpu",
                         shrink=ENHANCE_SHRINK)
    assert list(r) == KEYS + ["checks"]
    assert r["correct"] is True
    assert set(r["metrics"]) == {"enhance_utts_per_s",
                                 "enhance_batch_p95_ms", "setup_s"}
    t = harness.run_cell("enhance.f32.b64", 3, 0.2, True, device="cpu",
                         shrink=ENHANCE_SHRINK)
    assert list(t) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(t["device"])
    assert set(t["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in t["checks"].values():
        assert set(c) == {"value", "limit"} and c["limit"] is not None


def test_without_a_card_no_result_and_a_failing_exit():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "enhance.f32.b64",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_check_without_a_limit_is_refused_when_defined():
    checks = harness.Checks({"a": {"limit": 1.0, "why": "x"}})
    with pytest.raises(KeyError):
        checks.define("b", 0.0)
    checks.define("a", 0.5)
    assert checks.correct


@pytest.mark.parametrize("spec", [{"why": "x"}, {"limit": None, "why": "x"},
                                  {"limit": math.nan, "why": "x"},
                                  {"limit": -1, "why": "x"},
                                  {"limit": True, "why": "x"},
                                  {"limit": 1.0}])
def test_a_limit_that_is_missing_or_not_a_number_is_refused(spec):
    with pytest.raises(ValueError):
        harness.Checks({"a": spec})


def test_correct_is_exactly_every_number_within_its_limit():
    limits = {"a": {"limit": 1.0, "why": "x"}, "b": {"limit": 0, "why": "y"}}
    c = harness.Checks(limits)
    c.define("a", 1.0)
    assert not c.correct and c.missing == ["b"]     # b never defined
    c.define("b", 0.0)
    assert c.correct
    c.define("a", math.nan)
    assert not c.correct
    c.define("a", 1.0000001)
    assert not c.correct


def test_files_dropped_into_a_copy_are_found_by_name(tmp_path):
    """A new configuration, traffic, cell and per-layer metric, each a file
    of its own, run with no edit to the harness's code."""
    copy = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.load(open(copy / "configs" / "nelegan_f32.json"))
    cfg["name"] = "nelegan_f32_copy"
    json.dump(cfg, open(copy / "configs" / "nelegan_f32_copy.json", "w"))
    traffic = dict(json.load(open(copy / "traffic" / "enhance.b64.json")),
                   **ENHANCE_SHRINK)
    json.dump(traffic, open(copy / "traffic" / "enhance.tiny.json", "w"))
    cell = json.load(open(copy / "workloads" / "enhance.f32.b64.json"))
    cell.update(config="nelegan_f32_copy", traffic="enhance.tiny")
    json.dump(cell, open(copy / "workloads" / "enhance.tiny.json", "w"))
    (copy / "metrics" / "probe.batches.py").write_text(
        "UNIT = 'batches'\n\n\ndef read(ctx):\n"
        "    b = ctx.layer.get('batches')\n"
        "    return None if b is None else len(b)\n")
    code = ("import json, sys; sys.path[:0] = [%r, %r];"
            "from portbench import harness; assert harness.ROOT == "
            "__import__('pathlib').Path(%r); harness.set_environment();"
            "print(json.dumps(harness.run_cell('enhance.tiny', 9, 0.2, True, "
            "device='cpu')))" % (str(tmp_path), ROOT, str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["metrics"]["probe.batches"]["value"] > 0


def test_a_hook_the_program_lost_stops_the_run_with_its_name():
    from types import SimpleNamespace

    from portbench import adapter
    timer = SimpleNamespace(phase=lambda n: None, report=lambda: {})
    trainer = SimpleNamespace(
        _pooled_cn_bands=lambda g: None, run_epoch=lambda e: None,
        timer=timer, replay=None, train_index=None, state=None, paths=None)
    gan = SimpleNamespace(g_step_bands=lambda *a: None)
    with pytest.raises(adapter.ProgramChanged,
                       match="d_step_bands.*_eb_keys_compute"):
        adapter.check(gan, trainer)


def test_steps_that_go_past_the_wrappers_stop_the_run():
    from types import SimpleNamespace

    from portbench import adapter
    timer = SimpleNamespace(phase=lambda n: None, report=lambda: {})
    trainer = SimpleNamespace(
        _pooled_cn_bands=lambda g: None, _eb_keys_compute=lambda g, b: None,
        run_epoch=lambda e: None, timer=timer, replay=None, train_index=None,
        state=None, paths=None)
    gan = SimpleNamespace(g_step_bands=lambda *a: None,
                          d_step_bands=lambda *a: None)
    rec = adapter.Recorder(gan, trainer)
    trainer._pooled_cn_bands(["a.wav"])
    with pytest.raises(adapter.ProgramChanged, match="never called"):
        rec.verify()


@pytest.mark.parametrize("config", ["nelegan_f32", "nelegan_bf16"])
def test_every_configuration_states_its_host_threads(config, monkeypatch):
    for var in harness.THREAD_VARS:
        monkeypatch.delenv(var, raising=False)
    n = harness.set_host_threads(harness.load_json("configs", config))
    assert n == 1 and "host_threads" in harness.load_json(
        "configs", config)["assumed"]
    assert all(os.environ[v] == "1" for v in harness.THREAD_VARS)

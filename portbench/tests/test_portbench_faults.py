"""The comparison fails what it must: the timed path broken underneath a
run, and the control (the reference in the nearest precision below the
configuration's, put in the program's place).  CPU runs at a size a test
holds; the float32 cells' TF32 control exists only on the card.

Faults a cell can have: a step that returns its state unchanged; half of
the batch left out, the mean taken over the rest; an answer altered where
it is produced.  No cell runs over chips, so no exchange can be left out.
"""
import numpy as np
import pytest

from conftest import ENHANCE_SHRINK, TRAIN_SHRINK
from portbench import harness


def run(cell, fault=None, control=False, seed=20260101, shrink=TRAIN_SHRINK):
    harness.set_environment()
    return harness.run_cell(cell, seed, 0.1, False, device="cpu",
                            fault=fault, control=control, shrink=shrink)


def unchanged_state(where, trainer):
    for opt in (trainer.state.gen_opt, trainer.state.d_opt,
                trainer.state.dq_opt):
        opt.step = lambda *a, **k: None


def warm_unchanged_state(where, trainer):
    """The state left unchanged only once warm: every step from epoch 3,
    the window's first, on."""
    run_epoch = trainer.run_epoch

    def run(epoch):
        if epoch == 3:
            unchanged_state(where, trainer)
        return run_epoch(epoch)
    trainer.run_epoch = run


def half_batch(monkeypatch):
    from nelegan_tpu_torch.train import gan
    orig = gan._row_weights

    def rows(row_valid, b, dtype, dev):
        rv, _ = orig(row_valid, b, dtype, dev)
        rv = rv.clone()
        rv[b // 2:] = 0.0
        return rv, rv.sum().clamp_min(1.0)
    monkeypatch.setattr(gan, "_row_weights", rows)


def altered_pcm(monkeypatch):
    from nelegan_tpu_torch import pipeline
    orig = pipeline.pcm16_quantize_i16

    def quantize(wav):
        q = orig(wav).clone()
        q[0, 1000:1010] += 40
        return q
    monkeypatch.setattr(pipeline, "pcm16_quantize_i16", quantize)


def altered_scores(where, trainer):
    score = trainer._score_files

    def scored(*a, **k):
        out = score(*a, **k)
        for s in out:
            s["haspi"] = s["haspi"] + 0.02
        return out
    trainer._score_files = scored


def test_train_sound_run_is_correct():
    r = run("train.f32.b8")
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged_state", "warm_unchanged_state",
                                   "half_batch", "altered_pcm",
                                   "altered_scores"])
def test_train_fault_is_not_correct(fault, monkeypatch):
    hook = None
    if fault == "unchanged_state":
        hook = unchanged_state
    elif fault == "warm_unchanged_state":
        hook = warm_unchanged_state
    elif fault == "half_batch":
        half_batch(monkeypatch)
    elif fault == "altered_pcm":
        altered_pcm(monkeypatch)
    else:
        hook = altered_scores
    r = run("train.f32.b8", fault=(lambda w, o: hook(w, o)) if hook else None)
    assert r["correct"] is False, r["checks"]


def enhance_fault(kind):
    def fault(where, obj):
        if where != "output":
            return obj
        out = obj.copy()
        if kind == "half_batch":
            out[out.shape[0] // 2:] = 0
        else:
            out[0, 2000:2010] += 40
        return out
    return fault


@pytest.mark.parametrize("kind", ["half_batch", "altered_pcm"])
def test_enhance_fault_is_not_correct(kind):
    r = run("enhance.f32.b64", fault=enhance_fault(kind),
            shrink=ENHANCE_SHRINK)
    assert r["correct"] is False, r["checks"]


def test_bf16_control_fails_the_limits():
    """The float8 control of the bfloat16 cell, on the CPU: some number
    over its limit, while the program's are within."""
    r = run("train.bf16.b64", control=True)
    limits = {n: c["limit"] for n, c in r["checks"].items()}
    assert r["correct"], r["checks"]
    assert any(v > limits[n] for n, v in r["control"].items()), r["control"]


@pytest.mark.parametrize("cell,shrink", [("train.f32.b8", TRAIN_SHRINK),
                                         ("enhance.f32.b64", ENHANCE_SHRINK)])
@pytest.mark.card
def test_tf32_control_fails_the_limits(card, cell, shrink):
    r = harness.run_cell(cell, 20260102, 0.1, False, device=card,
                         control=True, shrink=shrink)
    limits = {n: c["limit"] for n, c in r["checks"].items()}
    assert r["correct"], r["checks"]
    assert any(v > limits[n] for n, v in r["control"].items()), r["control"]
    assert np.isfinite(list(r["control"].values())).all()

"""The port's ViSQOL (metrics/visqol.py) against the JAX package's, float64
on the CPU: parity, padded rows against trimmed, a batch against a loop, a
sub-patch clip, and three rows of the committed ViSQOL fit grid."""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nelegan_tpu.metrics import visqol as jvisqol
from nelegan_tpu_torch.metrics import pesq, visqol

JAX_BAR = 1e-9           # relative, float64 round-off
GRID_BAR = 5e-3          # tests/test_visqol.py's bar against the grid
TESTS = os.path.dirname(os.path.abspath(__file__))
N = 20000


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(goldens):
    g = goldens("features")
    ref = g["clean"][2000:2000 + N].astype(np.float64)
    deg = 0.9 * ref + 0.1 * g["noise"][5000:5000 + N].astype(np.float64)
    return ref, deg


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


@pytest.mark.parametrize("n", [N, 5000])
def test_visqol_matches_jax(pair, n):
    """1.25 s, and a 5000-sample clip (20 frames: shorter than one 30-frame
    patch, so the frames are padded to one)."""
    ref, deg = (x[:n] for x in pair)
    want = float(jvisqol.visqol_nsim_16k(jnp.asarray(ref), jnp.asarray(deg)))
    got = visqol.visqol_nsim_16k(torch.from_numpy(ref), torch.from_numpy(deg))
    assert got.dtype == torch.float64 and got.shape == ()
    assert _rel(got, want) < JAX_BAR, (float(got), want)
    mos = visqol.visqol_speech(torch.from_numpy(ref), torch.from_numpy(deg))
    want_mos = np.clip(1.0 + jvisqol.MOS_A * np.exp(
        jvisqol.MOS_Q * (want - 1.0)), 1.0, 4.73)
    assert _rel(mos, want_mos) < JAX_BAR


def test_visqol_batch_padded_and_trimmed(pair):
    """A batch of zero-padded rows with n_valid equals each row scored
    alone, bit for bit up to round-off; a padded row scores as its trimmed
    signal within the reference package's bucketed bar (frames past the
    valid region are masked, the last partial frame is not trimmed)."""
    ref, deg = pair
    lens = [N, 15000, 5000]
    r = np.zeros((3, N))
    d = np.zeros((3, N))
    for j, m in enumerate(lens):
        r[j, :m], d[j, :m] = ref[:m], deg[:m]
    nv = torch.tensor(lens)
    got = visqol.visqol_nsim_16k(torch.from_numpy(r), torch.from_numpy(d), nv)
    for j, m in enumerate(lens):
        alone = visqol.visqol_nsim_16k(torch.from_numpy(r[j]),
                                       torch.from_numpy(d[j]), m)
        assert float(got[j]) == pytest.approx(float(alone), rel=1e-12)
        trimmed = visqol.visqol_nsim_16k(torch.from_numpy(ref[:m]),
                                         torch.from_numpy(deg[:m]))
        assert abs(float(got[j]) - float(trimmed)) < 2e-3, j
    want = float(jvisqol.visqol_nsim_16k(jnp.asarray(r[1]), jnp.asarray(d[1]),
                                         jnp.asarray(lens[1])))
    assert _rel(got[1], want) < JAX_BAR


def _grid_pairs():
    """tools/fit_visqol_map.build_grid's synth0/noisy+10, synth0/clip0.15
    and synth1/bandgain1.6, built as it builds them (only these three)."""
    sys.path.insert(0, os.path.join(TESTS, "..", "tools"))
    from calibration_audit import _mix, _speech_signals
    from fit_visqol_map import _band_gain_deg
    sig = {}
    for name, clean, noise in _speech_signals():
        sig[name] = (clean / max(np.sqrt((clean ** 2).mean()), 1e-12) * 0.03,
                     noise)
    c0, n0 = sig["synth0"]
    c1, _ = sig["synth1"]
    thr = 0.15 * np.abs(c0).max()
    return {"synth0/noisy+10": (c0, c0 + _mix(c0, n0, 10.0)),
            "synth0/clip0.15": (c0, np.clip(c0, -thr, thr)),
            "synth1/bandgain1.6": (c1, _band_gain_deg(c1, 1.6, seed=16))}


def test_visqol_and_pesq_match_fit_grid():
    """nsim of three committed grid rows (tests/goldens/visqol_fit_grid.json,
    the JAX package's float32) within GRID_BAR, as tests/test_visqol.py
    holds the JAX package; their P.862.2 MOS-LQO too."""
    with open(os.path.join(TESTS, "goldens", "visqol_fit_grid.json")) as f:
        rows = {r["cond"]: r for r in json.load(f)["rows"]}
    for cond, (c, d) in _grid_pairs().items():
        n = min(len(c), len(d))
        ct, dt = torch.from_numpy(c[:n]), torch.from_numpy(d[:n])
        nsim = float(visqol.visqol_nsim_16k(ct, dt))
        mos = float(pesq.mos_lqo_wb(pesq.pesq_p862_16k(ct, dt, n)))
        assert abs(nsim - rows[cond]["nsim"]) < GRID_BAR, (cond, nsim)
        assert abs(mos - rows[cond]["pesq_mos"]) < GRID_BAR, (cond, mos)

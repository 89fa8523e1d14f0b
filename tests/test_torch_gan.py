"""Port GAN training steps (nelegan_tpu_torch.train.gan) against the
reference package's, from one JAX TrainState carried across with
train_state_from_jax: a narrow generator (hidden 32, 3 blocks), the real
discriminator widths, B = 3 with one shape-padding row, T = 28.

Bar for the steps, float64: every tensor of the state (parameters, spectral
u and v, Adam moments) and every loss within 1e-9 of the reference
package's, relative to the tensor's largest magnitude.  Both sides do the
same float64 arithmetic in other orders (Adam's update too: optax divides
m_hat by sqrt(v_hat) + eps, torch scales m by lr / bc1 over
sqrt(v) / sqrt(bc2) + eps), so they differ by round-off only."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from nelegan_tpu import pipeline as jpipe
from nelegan_tpu.config import Config as JaxConfig
from nelegan_tpu.config import ModelConfig as JaxModelConfig
from nelegan_tpu.train import gan as jgan
from nelegan_tpu_torch import pipeline as tpipe
from nelegan_tpu_torch.config import Config, ModelConfig
from nelegan_tpu_torch.models.convert import train_state_from_jax
from nelegan_tpu_torch.train import gan

HIDDEN, BLOCKS = 32, 3
B, T = 3, 28
JCFG = dataclasses.replace(JaxConfig(), model=JaxModelConfig(
    gen_hidden=HIDDEN, gen_blocks=BLOCKS))
CFG = dataclasses.replace(Config(), model=ModelConfig(
    gen_hidden=HIDDEN, gen_blocks=BLOCKS))
INTEL_COLS, QUALITY_COLS = (1, 0, 1), (1, 0)
RTOL = 1e-9


def _f64(a):
    return a.astype(np.float64) if a.dtype == np.float32 else a


def _inputs():
    """Bands [B, T, 64] with ragged frames; row 2 repeats row 1 as shape
    padding (row_valid 0), as the training loop pads a ragged batch."""
    rng = np.random.RandomState(0)
    cb, nb, eb = (rng.rand(B, T, 64) + 0.05 for _ in range(3))
    frames = np.array([T, 24, 24], np.int32)
    for a in (cb, nb, eb):
        a[2] = a[1]
    tg = rng.uniform(0.2, 0.9, (3, B, 3))
    tq = rng.uniform(0.2, 0.9, (3, B, 2))
    return cb, nb, eb, frames, np.array([1.0, 1.0, 0.0]), tg, tq


@pytest.fixture(scope="module")
def runs():
    """Three G steps then three D steps on both packages from one JAX
    init: (JAX state after the G steps, after all steps, JAX losses, port
    state after the G steps, after all steps, port losses)."""
    init = jax.jit(lambda key: jax.tree.map(
        _f64, jgan.init_train_state(key, JCFG)))
    js = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    ts = train_state_from_jax(js, CFG, device="cpu")
    cb, nb, eb, fr, rv, tg, tq = _inputs()
    jl, tl = [], []
    for _ in range(3):
        js, loss = jgan.g_step_bands(js, cb, nb, fr, JCFG, INTEL_COLS, None,
                                     rv)
        jl.append(float(loss))
        ts, loss = gan.g_step_bands(ts, cb, nb, fr, CFG, INTEL_COLS, None, rv)
        tl.append(float(loss))
    js_g, ts_g = jax.tree.map(np.asarray, js), copy.deepcopy(ts)
    for i in range(3):
        js, ld, lq = jgan.d_step_bands(js, eb, nb, cb, fr, tg[i], tq[i],
                                       JCFG, quality_cols=QUALITY_COLS,
                                       row_valid=rv)
        jl += [float(ld), float(lq)]
        ts, ld, lq = gan.d_step_bands(ts, eb, nb, cb, fr, tg[i], tq[i], CFG,
                                      quality_cols=QUALITY_COLS, row_valid=rv)
        tl += [float(ld), float(lq)]
    return (js_g, jax.tree.map(np.asarray, js), jl, ts_g, ts, tl)


def _assert_states_close(got: gan.TrainState, want: gan.TrainState):
    """Every tensor of two port states within RTOL of `want`'s largest
    magnitude; step counters equal."""
    a, b = got.state_dict(), want.state_dict()
    assert (a["step_g"], a["step_d"]) == (b["step_g"], b["step_d"])
    pairs = []
    for name in ("gen", "d", "dq"):
        pairs += [(f"{name}.{k}", v, b[name][k]) for k, v in a[name].items()]
    for name in ("gen_opt", "d_opt", "dq_opt"):
        for i, st in a[name]["state"].items():
            for k, v in st.items():
                pairs.append((f"{name}.{i}.{k}", v, b[name]["state"][i][k]))
    for key, x, y in pairs:
        x, y = x.double(), y.double()
        err = float((x - y).abs().max())
        assert err <= RTOL * max(float(y.abs().max()), 1e-300), (key, err)


def test_steps_match_jax_f64(runs):
    js_g, js, jl, ts_g, ts, tl = runs
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=0)
    # after the G steps: the generator moved, and both discriminators'
    # power iterations advanced with JAX's (their parameters did not move)
    _assert_states_close(ts_g, train_state_from_jax(js_g, CFG, device="cpu"))
    _assert_states_close(ts, train_state_from_jax(js, CFG, device="cpu"))
    assert (ts.step_g, ts.step_d) == (3, 3)
    assert ts.gen_opt.state_dict()["state"][0]["step"] == 3.0


def test_g_step_moves_no_discriminator_parameter():
    state = gan.init_train_state(CFG, 1, "cpu", dtype=torch.float64)
    cb, nb, _, fr, rv, _, _ = _inputs()
    before = copy.deepcopy(state)
    gan.g_step_bands(state, cb, nb, fr, CFG, row_valid=rv)
    for new, old in ((state.d, before.d), (state.dq, before.dq)):
        for (k, p), q in zip(new.named_parameters(), old.parameters()):
            assert torch.equal(p, q) and p.grad is None, k
            assert p.requires_grad, k
        assert not torch.equal(new.fc3.weight_u, old.fc3.weight_u)
    assert not torch.equal(state.gen.fc2.weight, before.gen.fc2.weight)


def test_per_column_gating_and_frozen_head():
    """Mirrors tests/test_gating.py: unscored columns carry no loss on
    either side, and a head with update_*=False is untouched."""
    state = gan.init_train_state(CFG, 2, "cpu", dtype=torch.float64)
    cb, nb, eb, fr, _, tg, tq = _inputs()
    t3 = tg[0].copy()
    t3[:, :2] = 0.5                 # made-up targets of unscored columns
    img3, img2 = gan.d_images(*(torch.from_numpy(a) for a in (eb, nb, cb)),
                              torch.from_numpy(fr))
    probe = copy.deepcopy(state.d).train()
    with torch.no_grad():
        score = probe(img3, torch.from_numpy(fr)).numpy()
    _, ld_col, lq = gan.d_step(copy.deepcopy(state), img3, img2, fr, t3,
                               tq[0], CFG, intel_cols=(0, 0, 1))
    np.testing.assert_allclose(float(ld_col),
                               np.mean((score[:, 2] - t3[:, 2]) ** 2),
                               rtol=1e-12)
    _, ld_all, _ = gan.d_step(copy.deepcopy(state), img3, img2, fr, t3,
                              tq[0], CFG)
    assert abs(float(ld_all) - float(ld_col)) > 1e-7
    _, gl_all = gan.g_step_bands(copy.deepcopy(state), cb, nb, fr, CFG)
    _, gl_col = gan.g_step_bands(copy.deepcopy(state), cb, nb, fr, CFG,
                                 intel_cols=(0, 0, 1), quality_cols=(1, 1))
    assert abs(float(gl_all) - float(gl_col)) > 1e-7

    before = copy.deepcopy(state)
    _, ld, lq = gan.d_step(state, img3, img2, fr, t3, tq[0], CFG,
                           update_quality=False)
    assert float(ld) > 0 and float(lq) == 0.0
    for k, v in before.dq.state_dict().items():
        assert torch.equal(v, state.dq.state_dict()[k]), k
    assert not state.dq_opt.state_dict()["state"]
    assert not torch.equal(before.d.fc1.weight_orig, state.d.fc1.weight_orig)
    assert state.step_d == 1


def _pad_rows(a, total):
    return np.concatenate([a, np.repeat(a[-1:], total - len(a), 0)])


def test_row_masking_makes_padding_inert():
    """Mirrors tests/test_row_masking.py: two real rows padded to four with
    row_valid give the unpadded batch's losses and updates."""
    state = gan.init_train_state(CFG, 3, "cpu", dtype=torch.float64)
    cb, nb, eb, fr, _, tg, tq = (a[:2] if isinstance(a, np.ndarray)
                                 and a.shape[0] == B else a
                                 for a in _inputs())
    mask = np.array([1.0, 1.0, 0.0, 0.0])
    pad = [_pad_rows(a, 4) for a in (cb, nb, eb, fr)]
    s0, l0 = gan.g_step_bands(copy.deepcopy(state), cb, nb, fr, CFG)
    s1, l1 = gan.g_step_bands(copy.deepcopy(state), *pad[:2], pad[3], CFG,
                              row_valid=mask)
    _, l2 = gan.g_step_bands(copy.deepcopy(state), *pad[:2], pad[3], CFG)
    assert abs(float(l0) - float(l1)) < 1e-12
    assert abs(float(l0) - float(l2)) > 1e-7
    torch.testing.assert_close(s0.gen.fc1.weight, s1.gen.fc1.weight,
                               rtol=0, atol=1e-12)
    _, d0, q0 = gan.d_step_bands(copy.deepcopy(state), eb, nb, cb, fr,
                                 tg[0, :2], tq[0, :2], CFG)
    _, d1, q1 = gan.d_step_bands(copy.deepcopy(state), pad[2], pad[1],
                                 pad[0], pad[3], _pad_rows(tg[0, :2], 4),
                                 _pad_rows(tq[0, :2], 4), CFG, row_valid=mask)
    assert abs(float(d0) - float(d1)) < 1e-12
    assert abs(float(q0) - float(q1)) < 1e-12


def test_d_steps_scan_skips_padding_groups():
    """Three groups, the middle one shape padding: the scan equals the two
    valid groups' d_step_bands in turn, bit for bit, and the skipped group
    neither moves the state nor counts a step."""
    state = gan.init_train_state(CFG, 4, "cpu", dtype=torch.float64)
    cb, nb, eb, fr, rv, tg, tq = _inputs()
    flat = [np.concatenate([a] * 3) for a in (eb, cb, nb, fr)]
    rvs = np.stack([rv] * 3)
    scanned, losses = gan.d_steps_scan(
        copy.deepcopy(state), *flat, tg, tq, rvs, [True, False, True], CFG,
        quality_cols=QUALITY_COLS)
    manual = copy.deepcopy(state)
    want = []
    for g in (0, 2):
        _, ld, lq = gan.d_step_bands(manual, eb, nb, cb, fr, tg[g], tq[g],
                                     CFG, quality_cols=QUALITY_COLS,
                                     row_valid=rv)
        want.append([float(ld), float(lq)])
    assert losses.dtype == torch.float32 and losses.shape == (3, 2)
    assert losses[1].tolist() == [0.0, 0.0]
    np.testing.assert_array_equal(losses[[0, 2]].numpy(),
                                  np.float32(want))
    assert scanned.step_d == manual.step_d == 2
    a, b = scanned.state_dict(), manual.state_dict()
    for name in ("d", "dq"):
        for k, v in a[name].items():
            assert torch.equal(v, b[name][k]), (name, k)
    with pytest.raises(ValueError, match="group_valid"):
        gan.d_steps_scan(copy.deepcopy(state), *flat, tg, tq, rvs,
                         [True, True], CFG)


def test_d_step_enhanced_equals_the_band_path():
    """d_step_enhanced featurizes the enhanced wavs itself: the same update
    as d_step_bands on speech_band of them, bit for bit."""
    state = gan.init_train_state(CFG, 8, "cpu")
    rng = np.random.RandomState(8)
    enh = [(0.05 * rng.randn(n)).astype(np.float32) for n in (6912, 6000)]
    enh_padded, _ = tpipe.reflect_pad_batch(enh)     # 28 frames
    cb, nb, _, _, _, tg, tq = _inputs()
    cb, nb = (a[:2].astype(np.float32) for a in (cb, nb))
    fr = np.array([28, 24], np.int32)
    a, b = copy.deepcopy(state), copy.deepcopy(state)
    _, ld, lq = gan.d_step_enhanced(a, enh_padded, nb, cb, fr, tg[0, :2],
                                    tq[0, :2], CFG, row_valid=[1.0, 1.0])
    eband = gan.speech_band(enh_padded, CFG, device="cpu")
    _, ld2, lq2 = gan.d_step_bands(b, eband, nb, cb, fr, tg[0, :2],
                                   tq[0, :2], CFG, row_valid=[1.0, 1.0])
    assert (float(ld), float(lq)) == (float(ld2), float(lq2))
    for k, v in a.d.state_dict().items():
        assert torch.equal(v, b.d.state_dict()[k]), k


def test_featurize_triple_eband_and_reflect_pad_match_jax():
    """float32, the training dtype: images and frames of a ragged
    (enhanced, noise, clean) batch; the bands of enhanced rows straight
    from the device; the device reflect pad, exactly.  Band bars as
    test_torch_pipeline.py's float32 case (rtol 1e-5, atol 5e-6)."""
    rng = np.random.RandomState(6)
    lens = [8192, 6001]
    wav = [(0.05 * rng.randn(3, n)).astype(np.float32) for n in lens]
    padded = [tpipe.reflect_pad_batch([w[i] for w in wav])[0]
              for i in range(3)]
    lengths = np.array(lens, np.int32)
    j3, j2, jfr = jgan.featurize_triple(*padded, lengths, JCFG)
    t3, t2, tfr = gan.featurize_triple(*padded, lengths, CFG, device="cpu")
    np.testing.assert_array_equal(tfr.numpy(), np.asarray(jfr))
    for got, want in ((t3, j3), (t2, j2)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).transpose(0, 3, 1, 2),
                                   rtol=1e-5, atol=5e-6)

    enh = np.zeros((2, 8448), np.float32)
    enh[0] = 0.2 * rng.randn(8448)
    enh[1, :7680] = 0.2 * rng.randn(7680)
    out_lens = np.array([8448, 7680], np.int32)
    np.testing.assert_array_equal(
        tpipe.reflect_pad_device(torch.from_numpy(enh), out_lens).numpy(),
        np.asarray(jpipe.reflect_pad_device(enh, out_lens)))
    np.testing.assert_array_equal(
        tpipe.reflect_pad_device(torch.from_numpy(enh), out_lens).numpy(),
        tpipe.reflect_pad_batch([enh[0], enh[1, :7680]], 8448)[0])
    np.testing.assert_allclose(
        gan.eband_from_enhanced(torch.from_numpy(enh), out_lens, CFG,
                                device="cpu").numpy(),
        np.asarray(jgan.eband_from_enhanced(enh, out_lens, JCFG)),
        rtol=1e-5, atol=5e-6)


def test_init_train_state_is_seeded():
    a = gan.init_train_state(CFG, 5, "cpu")
    state = torch.random.get_rng_state()
    b = gan.init_train_state(CFG, 5, "cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    c = gan.init_train_state(CFG, 6, "cpu", gen_state=a.gen.state_dict())
    for x, y in zip(a.state_dict()["d"].values(),
                    b.state_dict()["d"].values()):
        assert torch.equal(x, y)
    assert torch.equal(c.gen.fc1.weight, a.gen.fc1.weight)
    assert not torch.equal(c.d.fc1.weight_orig, a.d.fc1.weight_orig)
    assert a.gen_opt.param_groups[0]["lr"] == 5e-4
    assert a.d_opt.param_groups[0]["lr"] == a.dq_opt.param_groups[0]["lr"] \
        == 2.5e-4

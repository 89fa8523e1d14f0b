"""Port IMCRA (plain frame loop, the CPU path of nelegan_tpu_torch's
imcra_scan) against the golden and against the JAX lax.scan."""
import numpy as np
import torch

from nelegan_tpu.dsp import imcra_estimate_psd as jax_imcra
from nelegan_tpu_torch.dsp import imcra


def _spec(seed, k=257, t=64):
    """Seeded noisy spectra with a level change mid-way, so the VADs and the
    minimum tracking both switch."""
    rng = np.random.RandomState(seed)
    level = np.where(np.arange(t) < t // 2, 1.0, 6.0)[None, :]
    re = rng.randn(k, t) * level
    im = rng.randn(k, t) * level
    return re + 1j * im


def test_imcra_golden_f64(goldens):
    g = goldens("imcra")
    spec = torch.from_numpy(g["spec_real"] + 1j * g["spec_imag"])
    ours = imcra.imcra_estimate_psd(spec).numpy()
    np.testing.assert_allclose(ours, g["psd"], rtol=1e-6, atol=1e-12)


def test_imcra_golden_f32(goldens):
    g = goldens("imcra")
    spec = torch.from_numpy((g["spec_real"] + 1j * g["spec_imag"])
                            .astype(np.complex64))
    ours = imcra.imcra_estimate_psd(spec).numpy()
    assert ours.dtype == np.float32
    rel = np.abs(ours - g["psd"]) / (np.abs(g["psd"]) + 1e-12)
    assert np.median(rel) < 1e-4
    assert np.percentile(rel, 99) < 2e-2


def test_imcra_matches_jax_f64():
    for seed, t in [(0, 64), (1, 47)]:
        spec = _spec(seed, t=t)
        ours = imcra.imcra_estimate_psd(torch.from_numpy(spec)).numpy()
        ref = np.asarray(jax_imcra(spec))
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-14)


def test_imcra_min_tracking_roll_matches_jax_f64():
    """At T = 170 the tracker fires 10 times, so from the 9th fire on the U = 8
    slot store rolls instead of filling a free slot."""
    spec = _spec(6, t=170)
    y2 = torch.from_numpy(np.abs(spec) ** 2).T[None].contiguous()
    psd, st = imcra.imcra_scan(y2)
    assert int(st.u[0]) == 10
    ref = np.asarray(jax_imcra(spec))
    np.testing.assert_allclose(psd[0].T.numpy(), ref, rtol=1e-6, atol=1e-14)


def test_imcra_batched_rows_are_independent():
    specs = np.stack([_spec(2, t=40), _spec(3, t=40)])
    both = imcra.imcra_estimate_psd(torch.from_numpy(specs)).numpy()
    for i in range(2):
        one = imcra.imcra_estimate_psd(torch.from_numpy(specs[i])).numpy()
        np.testing.assert_array_equal(both[i], one)


def test_imcra_step_state_resumes_mid_utterance():
    """Scanning frames [0, 37) then [37, T) with the carried state equals one
    scan over [0, T): 37 is not a multiple of V = 15, so the split falls
    inside a minimum-tracking window."""
    spec = np.stack([_spec(4, t=70), _spec(5, t=70)])
    y2 = torch.from_numpy(np.abs(spec) ** 2).transpose(1, 2).contiguous()
    whole, st_whole = imcra.imcra_scan(y2)
    first, st = imcra.imcra_scan(y2[:, :37].contiguous())
    second, st = imcra.imcra_scan(y2[:, 37:].contiguous(), st, l0=37)
    np.testing.assert_array_equal(torch.cat([first, second], 1).numpy(),
                                  whole.numpy())
    for a, b in zip(st, st_whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(st.u[0]) == 3   # 55 main frames fired the tracker 3 times


def test_imcra_stateless_scan_matches_plain_and_jax_f64():
    """The state-less form (what featurize_batch calls): the same PSD as the
    plain loop, no state, and the JAX lax.scan's PSD at f64."""
    spec = _spec(9, t=80)
    y2 = torch.from_numpy(np.abs(spec) ** 2).T[None].contiguous()
    psd, st = imcra.imcra_scan(y2, keep_state=False)
    assert st is None
    want, _ = imcra.imcra_scan_plain(y2)
    np.testing.assert_array_equal(psd.numpy(), want.numpy())
    np.testing.assert_array_equal(imcra.imcra_psd(y2).numpy(), want.numpy())
    ref = np.asarray(jax_imcra(spec))
    np.testing.assert_allclose(psd[0].T.numpy(), ref, rtol=1e-6, atol=1e-14)


def test_imcra_kernel_coefficients_cached_in_kernel_order():
    """One float32 array per config, in the order csrc/imcra.cu's ImcraCoef
    reads it, with the fresh start's lambda_init rounded as imcra_init
    rounds it."""
    import re
    from pathlib import Path

    from nelegan_tpu_torch.config import ImcraConfig
    src = (Path(imcra.__file__).resolve().parents[1] / "csrc"
           / "imcra.cu").read_text()
    struct = re.search(r"struct ImcraCoef \{[^}]*?float ([^;]*);", src).group(1)
    fields = [f.strip() for f in struct.split(",")]
    assert tuple(fields) == imcra._KERNEL_COEFFICIENTS
    n = int(re.search(r"kCoefficients = (\d+);", src).group(1))
    cfg = ImcraConfig()
    coef = imcra._kernel_coefficients(cfg)
    assert coef.dtype == np.float32 and coef.shape == (n,)
    assert imcra._kernel_coefficients(cfg) is coef
    init = imcra.imcra_init(3, torch.float32, cfg, device="cpu")
    assert coef[fields.index("lambda_init")] == init.lam[0].item()

"""Port streaming enhancer (nelegan_tpu_torch.streaming) against the JAX
package's StreamingEnhancer and against the port's own offline causal path,
on the same signals and generator parameters."""
import copy

import numpy as np
import pytest
import torch

from nelegan_tpu.models.convert import torch_generator_to_flax
from nelegan_tpu.models.generator import Generator as JaxGenerator
from nelegan_tpu.streaming import StreamingEnhancer as JaxStreamingEnhancer
from nelegan_tpu_torch import streaming
from nelegan_tpu_torch.config import ImcraConfig
from nelegan_tpu_torch.dsp import imcra
from nelegan_tpu_torch.models.generator import Generator

HIDDEN, BLOCKS = 32, 3
SIZES = [300, 1000, 7, 4096, 53]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's thread pool only spins, taking CPU from the
    test files that run beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def generators():
    """One seeded generator in both packages (the reference package's own
    init draws through flax, seconds of compilation on the CPU)."""
    tg = Generator(hidden=HIDDEN, n_blocks=BLOCKS)
    tg.reset_parameters(torch.Generator().manual_seed(0))
    tg = tg.double().eval()
    params = torch_generator_to_flax(
        {k: v.numpy() for k, v in tg.state_dict().items()}, n_blocks=BLOCKS)
    return params, tg


@pytest.fixture(scope="module")
def signals(goldens):
    """The golden speech and noise, twice over (263 frames: the IMCRA
    warm-up, 16 tracker fires, so the slot store rolls), at float64."""
    g = goldens("features")
    return (np.tile(g["clean"], 2).astype(np.float64),
            np.tile(g["noise"], 2).astype(np.float64))


def stream(se, clean, noise, sizes):
    outs, i, k = [], 0, 0
    while i < len(clean):
        sz = sizes[k % len(sizes)]
        k += 1
        outs.append(se.process(clean[i:i + sz], noise[i:i + sz]))
        i += sz
    outs.append(se.flush())
    return np.concatenate(outs)


def port_enhancer(tg, chunk_frames=8, **kw):
    return streaming.StreamingEnhancer(tg, chunk_frames=chunk_frames,
                                       dtype=np.float64, device="cpu", **kw)


def test_stream_matches_jax_across_warmup_and_slot_roll(generators, signals):
    params, tg = generators
    clean, noise = signals
    se = port_enhancer(tg)
    got = stream(se, clean, noise, SIZES)
    want = stream(JaxStreamingEnhancer(params, JaxGenerator(
        hidden=HIDDEN, n_blocks=BLOCKS), chunk_frames=8, dtype=np.float64),
        clean, noise, SIZES)
    assert got.shape == want.shape == (256 * (len(clean) // 256),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert int(se.state.imcra_ju[0, 1]) > ImcraConfig().u_buffers


def test_stream_matches_offline_causal(generators, signals):
    _, tg = generators
    clean, noise = signals
    got = stream(port_enhancer(tg), clean, noise, SIZES)
    want = streaming.enhance_offline_causal(tg, clean, noise,
                                            device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_stream_chunksize_invariant(generators, signals):
    _, tg = generators
    clean, noise = (x[:20000] for x in signals)
    a = stream(port_enhancer(tg, 1), clean, noise, [256])
    b = stream(port_enhancer(tg, 16), clean, noise, [8192])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


def test_stream_output_length_and_latency(generators, signals):
    _, tg = generators
    n = 4096 + 100
    clean, noise = (x[:n] for x in signals)
    se = port_enhancer(tg, 1)
    emitted_at, total = {}, 0
    for i in range(0, n, 256):
        out = se.process(clean[i:i + 256], noise[i:i + 256])
        if len(out):
            emitted_at.setdefault(total, i + 256)
            total += len(out)
    total += len(se.flush())
    assert total == 256 * (n // 256)
    # the first block (samples [0, 256)) appears once 512 samples are in
    assert emitted_at[0] == streaming.StreamingEnhancer.LATENCY_SAMPLES
    # a stream of at most one hop is reflect-padded at flush
    se.reset()
    assert len(se.process(clean[:200], noise[:200])) == 0
    assert len(se.flush()) == 0
    with pytest.raises(RuntimeError, match="flushed"):
        se.process(clean[:10], noise[:10])


def test_stream_final_beta_matches_utterance_beta(generators, signals):
    _, tg = generators
    clean, noise = (x[:33536] for x in signals)
    from nelegan_tpu_torch.dsp.features import featurize_noise, \
        featurize_speech
    cb, _, _ = featurize_speech(torch.from_numpy(clean))
    nb, _, _ = featurize_noise(torch.from_numpy(noise))
    with torch.no_grad():
        mask = tg(cb[None], nb[None])[0]
    cp = cb ** 6.0
    beta2_utt = float(cp.sum() / (mask * cp).sum())
    se = port_enhancer(tg)
    se.process(clean, noise)
    se.flush()
    beta2 = float(se.state.beta_num[0] / se.state.beta_den[0])
    assert abs(beta2 - beta2_utt) / beta2_utt < 1e-10


def test_batched_streams_match_independent(generators, signals):
    """streaming_step_batch advances B streams as B single streams do, over
    two steps (the second from carried state)."""
    _, tg = generators
    clean, noise = signals
    b, f = 3, 4

    def frames(x, i, step):
        o = (i * 7 + step * f) * 256
        return torch.from_numpy(np.stack([x[o + j * 256:o + j * 256 + 512]
                                          for j in range(f)]))

    singles = [streaming.init_stream_state(tg, 1, torch.float64,
                                           device="cpu") for _ in range(b)]
    batch = streaming.stack_stream_states(singles)
    with torch.no_grad():
        for step in range(2):
            batch, out = streaming.streaming_step_batch(
                tg, batch, torch.stack([frames(clean, i, step)
                                        for i in range(b)]),
                torch.stack([frames(noise, i, step) for i in range(b)]))
            assert out.shape == (b, f, 256)
            for i in range(b):
                singles[i], out_i = streaming.streaming_step(
                    tg, singles[i], frames(clean, i, step),
                    frames(noise, i, step))
                np.testing.assert_allclose(out[i].numpy(), out_i.numpy(),
                                           rtol=0, atol=1e-12)
    assert batch.frame_idx == 2 * f
    for i in range(b):
        np.testing.assert_allclose(batch.beta_num[i].numpy(),
                                   singles[i].beta_num[0].numpy(), rtol=1e-12)
        assert torch.equal(batch.imcra_ju[i], singles[i].imcra_ju[0])
    with pytest.raises(ValueError, match="frame_idx"):
        streaming.stack_stream_states([batch, streaming.init_stream_state(
            tg, 1, torch.float64, device="cpu")])


@pytest.mark.parametrize("cfg", [ImcraConfig(), ImcraConfig(is_frames=10)])
def test_carried_imcra_equals_one_scan(cfg):
    """IMCRA carried chunk by chunk in the kernel's packed layout (the
    streaming path on the CPU), with boundaries inside the warm-up, on
    tracker fires and in 1-frame chunks, equals one scan of all frames."""
    y2 = torch.from_numpy(np.random.RandomState(3).gamma(
        1.0, 1e-3, (2, 200, 33)).astype(np.float32))
    want, st = imcra.imcra_scan_plain(y2, cfg=cfg)
    rows, ju = imcra.pack_state(imcra.imcra_init(33, torch.float32, cfg,
                                                 (2,), "cpu"))
    got, t = [], 0
    for n in [1, 3, 11, 1, 14, 15, 30, 1, 1, 60, 63]:
        psd, rows, ju = streaming.carried_noise_psd(
            y2[:, t:t + n].contiguous(), rows, ju, t, cfg)
        got.append(psd)
        t += n
    assert t == 200
    assert torch.equal(torch.cat(got, 1), want)
    for a, b in zip(imcra.unpack_state(rows, ju), st):
        assert torch.equal(a, b)
    assert int(ju[0, 1]) > cfg.u_buffers


def test_step_shapes_and_float32(generators):
    _, tg = generators
    g32 = copy.deepcopy(tg).float()
    st = streaming.init_stream_state(g32, 2, device="cpu")
    assert st.imcra_rows.shape == (2, 26, 257)
    assert st.imcra_ju.dtype == torch.int32
    assert [c.shape for c in st.conv] == [(2, 128, 4), (2, HIDDEN, 6),
                                          (2, HIDDEN, 4)]
    fc = torch.zeros(2, 5, 512)
    with torch.no_grad():
        new, out = streaming.streaming_step_batch(g32, st, fc, fc)
    assert out.shape == (2, 5, 256) and out.dtype == torch.float32
    assert new.frame_idx == 5 and torch.isfinite(out).all()

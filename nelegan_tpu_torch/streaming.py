"""Frame-streaming enhancement with a fixed 32 ms latency.

Counterpart of `nelegan_tpu/streaming.py`.  The generator is causal
(left-padded convolutions and cumulative LayerNorm), so audio can go in
hop-sized pieces and come out 512 samples (32 ms at 16 kHz) later, equal to
the offline pipeline at the same frames with one documented difference: the
utterance-level energy normalisation beta^2 = sum(clean^6) /
sum(mask * clean^6) is replaced by its causal form, the same ratio over the
frames so far, which reaches the offline value at the last frame.  The
stream is not RMS-renormalised (a live stream cannot know its final RMS).

All recurrent state is an explicit `StreamState` with a leading stream axis:

  * STFT framing: the host slices the reflect-padded sample stream into
    centred 512/256 frames, as `dsp.stft` frames them;
  * IMCRA: the recursion carried across chunks in the `imcra_scan` kernel's
    own layout ([B, 26, K] float32 rows and [B, 2] int32 (j, u),
    `dsp/imcra.py` `pack_state`), so on the card a chunk of any number of
    frames, for one stream or a batch of streams, costs one kernel launch
    from the absolute frame index `frame_idx` and no state packing; on the
    CPU the plain frame loop runs from the same index;
  * generator: each causal conv carries its last k-1 input frames; each
    cumulative LayerNorm its running sum and power (the frame count is
    `frame_idx`);
  * overlap-add: one 256-sample tail.  With hop = n_fft / 2 every emitted
    block is normalised by the same 256-sample profile,
    `dsp.stft.ola_norm_half_overlap`, which the offline path shares.

Streams of one batch advance together: they share `frame_idx`, the
kernel's one absolute frame offset per launch.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nelegan_tpu_torch.config import ImcraConfig
from nelegan_tpu_torch.device import resolve_device
from nelegan_tpu_torch.dsp import imcra
from nelegan_tpu_torch.dsp.erb import band_energy, interp_band_gain
from nelegan_tpu_torch.dsp.features import (featurize_noise, featurize_speech,
                                            resynthesize)
from nelegan_tpu_torch.dsp.stft import hann_periodic, ola_norm_half_overlap
from nelegan_tpu_torch.models.generator import Generator

N_FFT = 512
HOP = 256


class StreamState(NamedTuple):
    """Recurrent state of B streams; every tensor leads with the stream
    axis B (a single stream is a batch of one)."""
    imcra_rows: torch.Tensor          # [B, 26, K] IMCRA state rows
    imcra_ju: torch.Tensor            # [B, 2] int32 (j, u)
    frame_idx: int                    # absolute frame counter
    conv: Tuple[torch.Tensor, ...]    # per conv layer: [B, Cin, k-1]
    cln_sum: torch.Tensor             # [B, L] cLN running sums
    cln_pow: torch.Tensor             # [B, L] cLN running powers
    beta_num: torch.Tensor            # [B] running sum of clean^6
    beta_den: torch.Tensor            # [B] running sum of mask * clean^6
    ola_tail: torch.Tensor            # [B, hop] overlap-add carry


def init_stream_state(gen: Generator, batch: int = 1,
                      dtype: torch.dtype = torch.float32,
                      imcra_cfg: ImcraConfig = ImcraConfig(),
                      device=None) -> StreamState:
    """A fresh state for `batch` streams on `device` (None: CUDA)."""
    dev = resolve_device(device)
    stat = torch.promote_types(dtype, torch.float32)
    rows, ju = imcra.pack_state(imcra.imcra_init(N_FFT // 2 + 1, stat,
                                                 imcra_cfg, (batch,), dev))
    convs = [block[0].conv for block in gen.convolutions]

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return StreamState(
        imcra_rows=rows, imcra_ju=ju, frame_idx=0,
        conv=tuple(z(batch, c.in_channels, c.kernel_size[0] - 1)
                   for c in convs),
        cln_sum=z(batch, len(convs), dt=stat),
        cln_pow=z(batch, len(convs), dt=stat),
        beta_num=z(batch), beta_den=z(batch), ola_tail=z(batch, HOP))


def stack_stream_states(states: Sequence[StreamState]) -> StreamState:
    """One state for the streams of `states` (each of any batch), which must
    be at the same frame."""
    idx = {s.frame_idx for s in states}
    if len(idx) != 1:
        raise ValueError(f"streams of one batch share frame_idx, got {idx}")
    return StreamState(
        imcra_rows=torch.cat([s.imcra_rows for s in states]),
        imcra_ju=torch.cat([s.imcra_ju for s in states]),
        frame_idx=states[0].frame_idx,
        conv=tuple(torch.cat(c) for c in zip(*(s.conv for s in states))),
        **{f: torch.cat([getattr(s, f) for s in states])
           for f in ("cln_sum", "cln_pow", "beta_num", "beta_den",
                     "ola_tail")})


# ------------------------------------------------------------------ IMCRA
def carried_noise_psd(y2: torch.Tensor, rows: torch.Tensor, ju: torch.Tensor,
                      l0: int, cfg: ImcraConfig = ImcraConfig()):
    """IMCRA over y2 [B, F, K] from the carried state (rows, ju) at absolute
    frame l0 -> (psd [B, F, K], rows, ju).  A CUDA tensor launches the
    `imcra_scan` kernel once (float32 only) or raises; a CPU tensor takes
    the plain frame loop."""
    if y2.device.type == "cpu":
        return carried_noise_psd_plain(y2, rows, ju, l0, cfg)
    return imcra.imcra_scan_packed(y2, rows, ju, l0, cfg, keep_state=True)


def carried_noise_psd_plain(y2: torch.Tensor, rows: torch.Tensor,
                            ju: torch.Tensor, l0: int,
                            cfg: ImcraConfig = ImcraConfig()):
    """`carried_noise_psd` through the plain frame loop, on any device."""
    psd, st = imcra.imcra_scan_plain(y2, imcra.unpack_state(rows, ju), l0,
                                     cfg)
    return (psd, *imcra.pack_state(st))


# -------------------------------------------------------------- generator
def _causal_conv_chunk(x: torch.Tensor, conv: torch.nn.Conv1d,
                       carry: torch.Tensor):
    """VALID conv over [carry, x] ([B, Cin, k-1 + F]) with the module's own
    [Cout, Cin, k] weights -> ([B, Cout, F], new carry [B, Cin, k-1])."""
    xin = torch.cat([carry, x], dim=-1)
    k = conv.kernel_size[0]
    return (F.conv1d(xin, conv.weight, conv.bias),
            xin[..., xin.shape[-1] - (k - 1):])


def _cln_chunk(x: torch.Tensor, cln, t0: int, sum0: torch.Tensor,
               pow0: torch.Tensor):
    """Cumulative LayerNorm over a chunk [B, C, F] from the running sum and
    power of the t0 frames before it; the same operations as
    `models.generator.CumulativeLayerNorm` at every frame."""
    sd = torch.promote_types(x.dtype, torch.float32)
    c, f = x.shape[1], x.shape[2]
    x32 = x.to(sd)
    cum_sum = sum0[:, None] + torch.cumsum(x32.sum(dim=1), dim=-1)     # [B, F]
    cum_pow = pow0[:, None] + torch.cumsum((x32 * x32).sum(dim=1), dim=-1)
    cnt = (c * torch.arange(t0 + 1, t0 + f + 1, device=x.device)).to(sd)
    mean = cum_sum / cnt
    var = (cum_pow - 2.0 * mean * cum_sum) / cnt + mean * mean
    inv_std = 1.0 / torch.sqrt(var + cln.eps)
    y = (x32 - mean[:, None, :]) * inv_std[:, None, :]
    return ((y * cln.gain0 + cln.bias0).to(x.dtype), cum_sum[:, -1],
            cum_pow[:, -1])


def _generator_chunk(gen: Generator, state: StreamState,
                     clean_band: torch.Tensor, noise_band: torch.Tensor):
    """The generator on a feature chunk [B, F, 64] x 2 with carried state:
    `Generator.forward` at these frames.  -> (mask [B, F, 64], conv carries,
    cLN sums, cLN powers)."""
    x = torch.cat([clean_band, noise_band], dim=-1).transpose(1, 2)
    carries, sums, pows = [], [], []
    for i, block in enumerate(gen.convolutions):
        x, carry = _causal_conv_chunk(x, block[0].conv, state.conv[i])
        x, s, p = _cln_chunk(x, block[2], state.frame_idx,
                             state.cln_sum[:, i], state.cln_pow[:, i])
        x = F.leaky_relu(x, gen.leaky_slope)
        carries.append(carry)
        sums.append(s)
        pows.append(p)
    x = x.transpose(1, 2)
    x = F.leaky_relu(gen.fc1(x), gen.leaky_slope)
    x = gen.fc2(x).to(torch.promote_types(x.dtype, torch.float32))
    mask = torch.exp(gen.mask_bound * torch.tanh(x))
    return mask, tuple(carries), torch.stack(sums, 1), torch.stack(pows, 1)


@functools.lru_cache(maxsize=None)
def _profiles(dtype: torch.dtype, device: torch.device):
    """(Hann window [512], OLA normaliser [256]) as tensors, built once per
    dtype and device; callers only read them."""
    return (torch.as_tensor(hann_periodic(N_FFT), dtype=dtype, device=device),
            torch.as_tensor(ola_norm_half_overlap(N_FFT), dtype=dtype,
                            device=device))


# ------------------------------------------------------------------- step
def streaming_step_batch(gen: Generator, state: StreamState,
                         clean_frames: torch.Tensor,
                         noise_frames: torch.Tensor,
                         p_power: float = 1.0 / 6.0,
                         imcra_cfg: ImcraConfig = ImcraConfig(),
                         noise_psd=carried_noise_psd):
    """Advance B streams by F centred STFT frames each.

    clean_frames / noise_frames: [B, F, 512] sample frames on the state's
    device.  Returns (new state, out [B, F, hop]): out[:, t] holds the
    enhanced samples of untrimmed block frame_idx + t (a stream's very first
    block is the centring pad; `StreamingEnhancer` drops it).  `noise_psd`
    runs IMCRA from the carried state (`carried_noise_psd`: the kernel on
    the card, one launch for all B streams; `carried_noise_psd_plain` where
    a run is held against the plain version)."""
    dt = clean_frames.dtype
    win, ola_norm = _profiles(dt, clean_frames.device)
    spec_c = torch.fft.rfft(clean_frames * win, dim=-1)        # [B, F, 257]
    clean_band = band_energy(spec_c.abs()) ** p_power          # [B, F, 64]
    spec_n = torch.fft.rfft(noise_frames * win, dim=-1)
    y2 = spec_n.real * spec_n.real + spec_n.imag * spec_n.imag
    y2 = y2.to(torch.promote_types(dt, torch.float32)).contiguous()
    psd, rows, ju = noise_psd(y2, state.imcra_rows, state.imcra_ju,
                              state.frame_idx, imcra_cfg)
    noise_band = band_energy(torch.sqrt(psd).to(dt)) ** p_power

    mask, conv, cln_sum, cln_pow = _generator_chunk(gen, state, clean_band,
                                                    noise_band)

    # causal beta^2: the energy-preservation ratio up to each frame
    clean_power = clean_band ** (1.0 / p_power)
    num = state.beta_num[:, None] + torch.cumsum(clean_power.sum(-1), -1)
    den = state.beta_den[:, None] + torch.cumsum((mask * clean_power).sum(-1),
                                                 -1)
    alpha2 = mask * (num / torch.clamp_min(den, 1e-30))[..., None]

    # resynthesis: band gains -> bin gains -> spectra -> overlap-add
    gain = torch.sqrt(interp_band_gain(alpha2))                # [B, F, 257]
    contrib = torch.fft.irfft(spec_c * gain, n=N_FFT, dim=-1) * win
    heads, tails = contrib[..., :HOP], contrib[..., HOP:]
    prev = torch.cat([state.ola_tail[:, None], tails[:, :-1]], dim=1)
    out = (heads + prev) / ola_norm

    new = StreamState(
        imcra_rows=rows, imcra_ju=ju,
        frame_idx=state.frame_idx + clean_frames.shape[1], conv=conv,
        cln_sum=cln_sum, cln_pow=cln_pow, beta_num=num[:, -1],
        beta_den=den[:, -1], ola_tail=tails[:, -1])
    return new, out


def streaming_step(gen: Generator, state: StreamState,
                   clean_frames: torch.Tensor, noise_frames: torch.Tensor,
                   p_power: float = 1.0 / 6.0,
                   imcra_cfg: ImcraConfig = ImcraConfig(),
                   noise_psd=carried_noise_psd):
    """One stream (a state of batch 1): frames [F, 512] -> (new state,
    out [F, hop])."""
    new, out = streaming_step_batch(gen, state, clean_frames[None],
                                    noise_frames[None], p_power, imcra_cfg,
                                    noise_psd)
    return new, out[0]


@torch.no_grad()
def enhance_offline_causal(gen: Generator, clean, noise,
                           p_power: float = 1.0 / 6.0,
                           imcra_cfg: ImcraConfig = ImcraConfig(),
                           device=None) -> torch.Tensor:
    """What a stream of the whole utterance emits, computed offline: the
    single-utterance path (`dsp.features`) with the causal beta^2 and no RMS
    renormalisation -> wav [256 * (n // 256)]."""
    dev = resolve_device(device)
    clean_band, mag, phase = featurize_speech(torch.as_tensor(clean,
                                                              device=dev),
                                              p_power)
    noise_band, _, _ = featurize_noise(torch.as_tensor(noise, device=dev),
                                       p_power, imcra_cfg)
    mask = gen(clean_band[None], noise_band[None])[0]
    clean_power = clean_band ** (1.0 / p_power)
    num = torch.cumsum(clean_power.sum(-1), -1)
    # leading digital silence has den == 0: the streaming step's guard
    den = torch.clamp_min(torch.cumsum((mask * clean_power).sum(-1), -1),
                          1e-30)
    return resynthesize(mask * (num / den)[:, None], mag, phase)


# -------------------------------------------------------------- host side
class StreamingEnhancer:
    """Host-side chunking around `streaming_step`.

    Feed sample chunks of any size with `process`; call `flush` at the end
    of the stream.  Exactly ``hop * (n // hop)`` samples come out for n
    samples in (the offline pipeline's output length).  Frames run in
    groups of `chunk_frames`, and `flush` drains what is left one frame at
    a time.  `gen` must already be on `device` (None: CUDA); on the card the
    stream runs in float32, the IMCRA kernel's type."""

    LATENCY_SAMPLES = N_FFT  # 32 ms at 16 kHz

    def __init__(self, gen: Generator, p_power: float = 1.0 / 6.0,
                 imcra_cfg: ImcraConfig = ImcraConfig(),
                 chunk_frames: int = 8, dtype=np.float32, device=None,
                 noise_psd=carried_noise_psd):
        self.device = resolve_device(device)
        p = next(gen.parameters())
        if p.device != self.device:
            raise ValueError(f"generator is on {p.device}, the stream on "
                             f"{self.device}; move it with gen.to(device)")
        self._gen = gen
        self._p_power = p_power
        self._imcra_cfg = imcra_cfg
        self._chunk = max(1, chunk_frames)
        self._dtype = np.dtype(dtype)
        self._noise_psd = noise_psd
        self.reset()

    @property
    def state(self) -> StreamState:
        return self._state

    def reset(self):
        self._state = init_stream_state(
            self._gen, 1, getattr(torch, self._dtype.name), self._imcra_cfg,
            self.device)
        self.steps = 0                               # streaming steps run
        self._pre_c = np.zeros((0,), self._dtype)   # raw head (pre-start)
        self._pre_n = np.zeros((0,), self._dtype)
        self._buf_c = np.zeros((0,), self._dtype)   # padded-stream leftover
        self._buf_n = np.zeros((0,), self._dtype)
        self._tail_c = np.zeros((0,), self._dtype)  # last raw samples
        self._tail_n = np.zeros((0,), self._dtype)
        self._frames_c: list = []                   # frames awaiting a chunk
        self._frames_n: list = []
        self._started = False
        self._first_block_dropped = False
        self._flushed = False

    # -- internals --------------------------------------------------------
    def _ingest(self, clean, noise):
        clean = np.asarray(clean, self._dtype).reshape(-1)
        noise = np.asarray(noise, self._dtype).reshape(-1)
        if clean.shape != noise.shape:
            raise ValueError("clean and noise chunks must be equal length")
        self._tail_c = np.concatenate([self._tail_c, clean])[-(HOP + 1):]
        self._tail_n = np.concatenate([self._tail_n, noise])[-(HOP + 1):]
        if not self._started:
            self._pre_c = np.concatenate([self._pre_c, clean])
            self._pre_n = np.concatenate([self._pre_n, noise])
            if len(self._pre_c) >= HOP + 1:
                # centring reflect pad: x[hop], ..., x[1] before x[0]
                self._buf_c = np.concatenate([self._pre_c[HOP:0:-1],
                                              self._pre_c])
                self._buf_n = np.concatenate([self._pre_n[HOP:0:-1],
                                              self._pre_n])
                self._pre_c = self._pre_n = np.zeros((0,), self._dtype)
                self._started = True
        else:
            self._buf_c = np.concatenate([self._buf_c, clean])
            self._buf_n = np.concatenate([self._buf_n, noise])
        if self._started:
            self._slice_frames()

    def _slice_frames(self) -> None:
        """Move complete frames from the padded stream buffers into the
        pending queues (mid-stream and at flush alike)."""
        while len(self._buf_c) >= N_FFT:
            self._frames_c.append(self._buf_c[:N_FFT].copy())
            self._frames_n.append(self._buf_n[:N_FFT].copy())
            self._buf_c = self._buf_c[HOP:]
            self._buf_n = self._buf_n[HOP:]

    def _run(self, n_frames: int) -> np.ndarray:
        fc = torch.from_numpy(np.stack(self._frames_c[:n_frames]))
        fn = torch.from_numpy(np.stack(self._frames_n[:n_frames]))
        del self._frames_c[:n_frames], self._frames_n[:n_frames]
        with torch.inference_mode():
            self._state, out = streaming_step(
                self._gen, self._state, fc.to(self.device),
                fn.to(self.device), self._p_power, self._imcra_cfg,
                self._noise_psd)
        self.steps += 1
        out = out.cpu().numpy().reshape(-1)
        if not self._first_block_dropped:
            out = out[HOP:]
            self._first_block_dropped = True
        return out

    def _drain(self, all_pending: bool) -> list:
        outs = []
        while len(self._frames_c) >= self._chunk:
            outs.append(self._run(self._chunk))
        if all_pending:
            while self._frames_c:
                outs.append(self._run(1))
        return outs

    def _joined(self, outs) -> np.ndarray:
        return np.concatenate(outs) if outs else np.zeros((0,), self._dtype)

    # -- public API -------------------------------------------------------
    def process(self, clean, noise) -> np.ndarray:
        """Feed one chunk of (clean speech, near-end noise) samples; returns
        the enhanced samples that became available (possibly none)."""
        if self._flushed:
            raise RuntimeError("stream already flushed; call reset()")
        self._ingest(clean, noise)
        return self._joined(self._drain(all_pending=False))

    def flush(self) -> np.ndarray:
        """End of stream: the final centring pad, then the remaining
        enhanced samples."""
        if self._flushed:
            return np.zeros((0,), self._dtype)
        self._flushed = True
        if not self._started:
            # a stream of <= hop samples: np.pad reflects repeatedly
            if len(self._pre_c) < 2:
                return np.zeros((0,), self._dtype)
            self._buf_c = np.pad(self._pre_c, HOP, mode="reflect")
            self._buf_n = np.pad(self._pre_n, HOP, mode="reflect")
            self._started = True
        else:
            # final reflect pad: x[n-2], ..., x[n-hop-1]
            self._buf_c = np.concatenate([self._buf_c,
                                          self._tail_c[-2:-(HOP + 2):-1]])
            self._buf_n = np.concatenate([self._buf_n,
                                          self._tail_n[-2:-(HOP + 2):-1]])
        self._slice_frames()
        return self._joined(self._drain(all_pending=True))

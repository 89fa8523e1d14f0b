"""End-to-end enhancement: featurize -> generator -> beta^2 -> resynthesis.

Counterpart of `nelegan_tpu/pipeline.py`.  Two paths:

  * `enhance_utterance`: the reference's single-utterance inference
    (reference: inference.py:80-115): centred STFT, IMCRA, generator mask,
    utterance-level energy normalisation beta^2 = sum(clean^6) /
    sum(mask * clean^6) (train_nele.py:133-138), band-gain resynthesis and
    the exact RMS renormalisation to 0.03 (inference.py:109).

  * `featurize_batch` + `enhance_batch`: the batched form the server runs.
    Utterances are reflect-padded *per utterance* on the host and
    zero-padded to a bucket length, so a center=False STFT over the batch
    reproduces each utterance's centred frames exactly; every frame past an
    utterance's own count is masked downstream.

Frame-count bookkeeping (hop 256, n_fft 512, centred):
  valid_frames(n)  = 1 + n // 256
  output_length(n) = 256 * (n // 256)   # the iSTFT truncates the tail
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nelegan_tpu_torch.config import ImcraConfig
from nelegan_tpu_torch.device import resolve_device
from nelegan_tpu_torch.dsp.asl_p56 import asl_p56_rows
from nelegan_tpu_torch.dsp.erb import band_energy, interp_band_gain
from nelegan_tpu_torch.dsp.features import (featurize_noise, featurize_speech,
                                            resynthesize, rms)
from nelegan_tpu_torch.dsp.imcra import imcra_psd
from nelegan_tpu_torch.dsp.stft import (hann_periodic, ola_norm_half_overlap,
                                        stft)

N_FFT = 512
HOP = 256


def valid_frames(n_samples):
    return 1 + n_samples // HOP


def _on_device(generator: torch.nn.Module, dev: torch.device) -> None:
    p = next(generator.parameters())
    if p.device != dev:
        raise ValueError(f"generator is on {p.device}, the run on {dev}; "
                         "move it with generator.to(device) first")


# ---------------------------------------------------------------------------
# Reference-exact single-utterance path
# ---------------------------------------------------------------------------

def enhance_utterance(generator: torch.nn.Module, clean_wav, noise_wav,
                      p_power: float = 1.0 / 6.0, target_rms: float = 0.03,
                      device=None) -> torch.Tensor:
    """One utterance through the reference inference path -> wav [(T-1)*hop]."""
    dev = resolve_device(device)
    _on_device(generator, dev)
    clean_wav = torch.as_tensor(clean_wav, device=dev)
    noise_wav = torch.as_tensor(noise_wav, device=dev)
    clean_band, clean_mag, clean_phase = featurize_speech(clean_wav, p_power)
    noise_band, _, _ = featurize_noise(noise_wav, p_power)
    mask = generator(clean_band[None], noise_band[None])[0]
    clean_power = clean_band ** (1.0 / p_power)
    beta2 = torch.sum(clean_power) / torch.sum(mask * clean_power)
    wav = resynthesize(mask * beta2, clean_mag, clean_phase)
    return wav / rms(wav) * target_rms


# ---------------------------------------------------------------------------
# Batched path
# ---------------------------------------------------------------------------

def reflect_pad_batch(wavs: list, n_max: int | None = None):
    """Host-side prep: per-utterance reflect pad (n_fft//2) then zero-pad to a
    common buffer.  Returns (padded [B, n_max + n_fft], lengths [B]) as numpy.
    int16 (raw PCM) stays int16: padding only copies samples, so converting
    after padding equals converting before, at half the bytes moved."""
    pad = N_FFT // 2
    lens = np.array([len(w) for w in wavs], np.int32)
    n_max = int(n_max or lens.max())
    dt = np.int16 if wavs and wavs[0].dtype == np.int16 else np.float32
    out = np.zeros((len(wavs), n_max + N_FFT), dt)
    for i, w in enumerate(wavs):
        p = np.pad(w, (pad, pad), mode="reflect")
        out[i, :len(p)] = p
    return out, lens


def reflect_pad_device(wav: torch.Tensor, lengths) -> torch.Tensor:
    """`reflect_pad_batch` for rows already on the device.

    wav [B, n] (row i valid through lengths[i] >= 258 samples) ->
    [B, n + 512]: each row reflected by 256 samples at its own two edges,
    zeros past lengths[i] + 512, as np.pad(w, (256, 256), 'reflect') placed
    at the buffer head.  One gather over computed indices."""
    n = wav.shape[-1]
    lengths = torch.as_tensor(lengths, device=wav.device)[:, None]
    j = torch.arange(n + N_FFT, device=wav.device)
    head = torch.abs(j - HOP)[None, :]                  # head reflection
    last = torch.clamp_min(lengths - 1, 1)
    idx = torch.clamp(last - torch.abs(last - head), 0, n - 1)  # tail
    out = torch.gather(wav, 1, idx)
    return torch.where(j[None, :] < lengths + N_FFT, out, 0.0)


def active_speech_level_batch(wavs, device=None) -> torch.Tensor:
    """ITU-T P.56 active speech level of each row of wavs [B, n] (numpy or
    a tensor) on `device` -> active-speech RMS [B], the square root of the
    P.56 mean square (floored at 1e-12), in the rows' dtype.  The reference
    ships asl_P56.py but never wires it in; the reference package offers it
    as a normalisation variant."""
    dev = resolve_device(device)
    w = torch.as_tensor(wavs, device=dev)
    msq, _, _ = asl_p56_rows(w, 16000, 16)
    return torch.sqrt(torch.clamp_min(
        torch.as_tensor(msq, dtype=w.dtype, device=dev), 1e-12))


class BatchFeatures(NamedTuple):
    clean_band: torch.Tensor   # [B, T, 64]
    noise_band: torch.Tensor   # [B, T, 64]
    clean_mag: torch.Tensor    # [B, 257, T]
    clean_phase: torch.Tensor  # [B, 257, T]
    frames: torch.Tensor       # [B] valid frame counts
    lengths: torch.Tensor      # [B] sample counts


def featurize_batch(clean_padded, noise_padded, lengths,
                    p_power: float = 1.0 / 6.0,
                    cfg: ImcraConfig = ImcraConfig(), device=None,
                    noise_psd=imcra_psd) -> BatchFeatures:
    """Batched featurization of host-pre-reflected utterances (numpy arrays or
    tensors) on `device`.

    Valid frames equal the reference's per-utterance centred STFT; padded
    tail frames are garbage and masked downstream.  int16 inputs are raw
    PCM16 and are converted on the device (x / 32768).  `noise_psd` maps
    |Y|^2 ``[B, T, K]`` and `cfg` to the IMCRA noise PSD of a fresh scan:
    the kernel wrapper (one launch, no state kept), or the plain version
    where a run is held against it."""
    dev = resolve_device(device)
    clean = torch.as_tensor(clean_padded, device=dev)
    noise = torch.as_tensor(noise_padded, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)
    if clean.dtype == torch.int16:
        clean = clean.to(torch.float32) / 32768.0
    if noise.dtype == torch.int16:
        noise = noise.to(torch.float32) / 32768.0
    cspec = stft(clean, center=False)                  # [B, 257, T]
    nspec = stft(noise, center=False)
    cmag = cspec.abs()
    cband = band_energy(cmag.transpose(-1, -2)) ** p_power
    y2 = nspec.real * nspec.real + nspec.imag * nspec.imag
    y2 = y2.to(torch.promote_types(y2.dtype, torch.float32))
    npsd = noise_psd(y2.transpose(-1, -2).contiguous(), cfg)  # [B, T, 257]
    nband = band_energy(torch.sqrt(npsd)) ** p_power
    return BatchFeatures(cband, nband, cmag, cspec.angle(),
                         valid_frames(lengths), lengths)


def frame_mask(frames: torch.Tensor, t: int) -> torch.Tensor:
    """[B, t] True where the frame index is valid."""
    return torch.arange(t, device=frames.device)[None, :] < frames[:, None]


def beta2_energy_norm(clean_band: torch.Tensor, mask: torch.Tensor,
                      fmask: torch.Tensor, inv_p: float = 6.0) -> torch.Tensor:
    """Utterance-level energy normalisation (reference train_nele.py:133-138),
    over valid frames.  Returns [B, 1, 1]."""
    clean_power = (clean_band ** inv_p) * fmask[..., None]
    num = torch.sum(clean_power, dim=(1, 2))
    den = torch.sum(mask * clean_power, dim=(1, 2))
    # an all-silent utterance has num == den == 0: unity gain, not 0/0
    ok = den > 0.0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 1.0)[:, None, None]


def istft_batch_tail_truncated(spec: torch.Tensor,
                               frames: torch.Tensor) -> torch.Tensor:
    """Batched iSTFT of center=False spectrograms [B, 257, T] of pre-reflected
    signals -> [B, (T-1)*hop].

    Invalid frames are zeroed before the overlap-add; inside the valid region
    every sample is covered by exactly two frames, so the squared-window
    normaliser is a tiled 256-periodic constant.  Output sample i is original
    sample i; samples at or beyond 256*(frames-1) are zeroed."""
    fr = torch.fft.irfft(spec.transpose(-1, -2), n=N_FFT, dim=-1)
    fr = fr * torch.as_tensor(hann_periodic(N_FFT), dtype=fr.dtype,
                              device=fr.device)
    b, t = fr.shape[0], fr.shape[-2]
    fr = fr * frame_mask(frames, t)[..., None]

    # overlap-add: out[f*HOP : f*HOP+N_FFT] += frame f, as two shifted adds
    first, second = fr[..., :HOP], fr[..., HOP:]
    second = torch.cat([torch.zeros_like(second[:, :1]), second[:, :-1]], dim=1)
    ola = (first + second).reshape(b, t * HOP)
    wsq = torch.as_tensor(ola_norm_half_overlap(N_FFT), dtype=ola.dtype,
                          device=ola.device)
    y = (ola / wsq.repeat(t))[:, HOP:]   # drop the leading reflect padding
    out_len = HOP * (frames - 1)
    keep = torch.arange(y.shape[-1], device=y.device)[None, :] < out_len[:, None]
    return torch.where(keep, y, 0.0)


def _pcm16_round(wav: torch.Tensor) -> torch.Tensor:
    """Clip, scale by 32768, clamp to 32767 and round half away from zero
    (libsndfile's PCM16 write, csrc/wavio.cpp); `torch.round` rounds half to
    even and is not used."""
    v = torch.clamp(wav, -1.0, 1.0)
    s = torch.clamp_max(v * 32768.0, 32767.0)
    return torch.where(s >= 0, torch.floor(s + 0.5), torch.ceil(s - 0.5))


def pcm16_quantize(wav: torch.Tensor) -> torch.Tensor:
    """The PCM16 disk round trip on the device: quantize, then /32768."""
    return _pcm16_round(wav) * (1.0 / 32768.0)


def pcm16_quantize_i16(wav: torch.Tensor) -> torch.Tensor:
    """The exact int16 samples a PCM16 file of `wav` holds."""
    return _pcm16_round(wav).to(torch.int16)


def enhance_batch(generator: torch.nn.Module, feats: BatchFeatures,
                  p_power: float = 1.0 / 6.0, target_rms: float = 0.03,
                  device=None):
    """Batched enhancement -> (wavs [B, n], alpha2 [B, T, 64], out_lens [B]).

    Per utterance this is the reference inference path, masked exactly.
    The generator must already be on `device`."""
    dev = resolve_device(device)
    _on_device(generator, dev)
    feats = BatchFeatures(*(f.to(dev) for f in feats))
    t = feats.clean_band.shape[1]
    fmask = frame_mask(feats.frames, t).to(feats.clean_band.dtype)
    mask = generator(feats.clean_band, feats.noise_band)
    beta2 = beta2_energy_norm(feats.clean_band, mask, fmask,
                              inv_p=1.0 / p_power)
    alpha2 = mask * beta2

    gain = torch.sqrt(interp_band_gain(alpha2))               # [B, T, 257]
    spec = (torch.polar(feats.clean_mag, feats.clean_phase)
            * gain.transpose(-1, -2))
    wav = istft_batch_tail_truncated(spec, feats.frames)

    out_len = HOP * (feats.frames - 1)
    denom = torch.sqrt(torch.sum(wav * wav, dim=-1)
                       / torch.clamp_min(out_len, 1).to(wav.dtype))
    # an all-zero row (sub-hop clip or silent input) keeps denominator 1:
    # zeros out, not a NaN row
    denom = torch.where(denom > 0.0, denom, 1.0)
    wav = wav / denom[:, None] * target_rms
    return wav, alpha2, out_len

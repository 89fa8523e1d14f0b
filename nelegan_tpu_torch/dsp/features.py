"""Featurization and resynthesis of one utterance (the L1 front end).

Counterparts of the reference's `Sp_and_phase_Speech` / `Sp_and_phase_Noise`
(audio_util.py:422-456) and `SP_to_wav`/`Resyn` (audio_util.py:458-461,
76-90), as `nelegan_tpu/dsp/features.py` writes them: constant-matrix band
ops and the IMCRA scan in place of per-frame loops.
"""
from __future__ import annotations

import torch

from nelegan_tpu_torch.config import ImcraConfig
from nelegan_tpu_torch.dsp.erb import band_energy, interp_band_gain
from nelegan_tpu_torch.dsp.imcra import imcra_estimate_psd
from nelegan_tpu_torch.dsp.stft import istft, stft


def featurize_speech(wav: torch.Tensor, power: float = 1.0 / 6.0):
    """wav [n] -> (band [T, 64] power-compressed, mag [257, T], phase [257, T])."""
    spec = stft(wav)
    mag = spec.abs()
    band = band_energy(mag.T) ** power
    return band, mag, spec.angle()


def featurize_noise(wav: torch.Tensor, power: float = 1.0 / 6.0,
                    cfg: ImcraConfig = ImcraConfig()):
    """wav [n] -> (band [T, 64] of the IMCRA noise PSD, mag, phase).  The band
    energies are taken of sqrt(PSD), not of the magnitudes."""
    spec = stft(wav)
    psd = imcra_estimate_psd(spec, cfg)
    band = band_energy(torch.sqrt(psd).T) ** power
    return band, spec.abs(), spec.angle()


def resynthesize(alpha2: torch.Tensor, mag: torch.Tensor,
                 phase: torch.Tensor) -> torch.Tensor:
    """Apply band energy gains alpha2 [T, 64] to mag, phase [257, T] and
    invert: per-bin gain sqrt(interp(alpha2)) with the frequency floors,
    times mag*e^{j*phase}, then the iSTFT -> [(T-1)*hop]."""
    gain = torch.sqrt(interp_band_gain(alpha2))          # [T, 257]
    spec = torch.polar(mag, phase) * gain.T              # [257, T]
    return istft(spec)


def rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))

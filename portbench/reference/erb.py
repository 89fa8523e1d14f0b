"""ERB band analysis / synthesis as constant matrices.

Counterpart of the reference package's `nelegan_tpu/dsp/erb.py`.  The
reference computes 64 triangular-interpolated band energies from 257 rFFT
bins with a per-frame loop (reference: audio_util.py:30-50) and expands 64
band gains back to 257 bins with another (audio_util.py:93-110); here each
direction is one matmul against a constant matrix.

  * analysis: ``bandE[i] += (1-frac) * |X[k]|^2``, ``bandE[i+1] += frac * |X[k]|^2``
    with ``frac = j / band_size`` for the j-th bin of band i;
  * synthesis: ``g[k] = (1-frac) * bandE[i] + frac * bandE[i+1]`` followed by
    the hard floors ``g[0] = g[1] = 1e-4``, ``g[256] = 1e-2``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.config import GMTBAND


@functools.lru_cache(maxsize=None)
def band_analysis_matrix(n_bins: int = 257, n_bands: int = 64) -> np.ndarray:
    """[n_bins, n_bands] matrix A with bandE = (mag**2) @ A."""
    edges = GMTBAND
    a = np.zeros((n_bins, n_bands), dtype=np.float64)
    for i in range(n_bands - 1):
        size = edges[i + 1] - edges[i]
        for j in range(size):
            frac = j / size
            k = edges[i] + j
            a[k, i] += 1.0 - frac
            a[k, i + 1] += frac
    return a


@functools.lru_cache(maxsize=None)
def band_synthesis_matrix(n_bins: int = 257, n_bands: int = 64) -> np.ndarray:
    """[n_bands, n_bins] matrix B with g = bandE @ B (before floors)."""
    edges = GMTBAND
    b = np.zeros((n_bands, n_bins), dtype=np.float64)
    for i in range(n_bands - 1):
        size = edges[i + 1] - edges[i]
        for j in range(size):
            frac = j / size
            k = edges[i] + j
            b[i, k] = 1.0 - frac
            b[i + 1, k] = frac
    return b


@functools.lru_cache(maxsize=None)
def _matrix(kind: str, n: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """The band matrix as a tensor, built once per (dtype, device); callers
    only read it.  Built outside inference mode whatever the first
    caller's mode: an inference tensor cannot be saved for a backward, and
    the cached matrix serves both inference (serving, scoring) and
    autograd (the direct step's resynthesis)."""
    m = (band_analysis_matrix(n) if kind == "analysis"
         else band_synthesis_matrix(n_bands=n))
    with torch.inference_mode(False):
        return torch.as_tensor(m, dtype=dtype, device=device)


def band_energy(mag: torch.Tensor) -> torch.Tensor:
    """``[..., T, n_bins]`` magnitudes (or sqrt-PSD) -> ``[..., T, n_bands]``
    band energies (reference `compute_band_E`, audio_util.py:30)."""
    return (mag * mag) @ _matrix("analysis", mag.shape[-1], mag.dtype,
                                 mag.device)


def interp_band_gain(band_e: torch.Tensor, floor_low: float = 1e-4,
                     floor_high: float = 1e-2) -> torch.Tensor:
    """``[..., T, n_bands]`` band gains -> ``[..., T, n_bins]`` bin gains with
    the low/high floors (reference `interp_band_gain`, audio_util.py:93-110)."""
    g = band_e @ _matrix("synthesis", band_e.shape[-1], band_e.dtype,
                         band_e.device)
    g[..., 0] = floor_low
    g[..., 1] = floor_low
    g[..., -1] = floor_high
    return g

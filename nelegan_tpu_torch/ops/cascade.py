"""Gammatone one-pole cascade: a plain PyTorch version and a CUDA kernel.

Counterpart of `nelegan_tpu/ops/pallas_scan.py` (`gammatone_cascade_pallas`
vmapped over rows): four cascaded identical one-poles
``y[n] = x[n] + a*y[n-1]`` per row, i.e. the gammatone denominator
``1/(1 - a z^-1)^4``, with a per-row pole ``a``.

No entry point of the port calls it, as no entry point of the reference
package calls its Pallas kernel (the HASPI ear model uses FFT convolution).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from nelegan_tpu_torch import kernels

BLOCK = 128


def gammatone_cascade_plain(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x [R, n], a [R] -> [R, n], as the Pallas body computes it: each
    128-sample block of each stage is a lower-triangular Toeplitz product
    ``a^(i-j)`` plus the carry injection ``a^(i+1) * c``."""
    r, n = x.shape
    nb = -(-n // BLOCK)
    xb = F.pad(x, (0, nb * BLOCK - n)).reshape(r, nb, BLOCK)
    a = a.to(x.dtype).reshape(r, 1, 1)
    i = torch.arange(BLOCK, device=x.device)
    d = (i[:, None] - i[None, :]).to(x.dtype)
    tri = torch.where(d >= 0, a ** d.clamp_min(0), torch.zeros((), dtype=x.dtype,
                                                               device=x.device))
    apow = (a * a ** i.to(x.dtype))[:, 0, :]                    # [R, BLOCK]
    carry = [torch.zeros(r, 1, dtype=x.dtype, device=x.device)
             for _ in range(4)]
    out = []
    for blk in range(nb):
        u = xb[:, blk, :]
        for s in range(4):
            u = (tri @ u[..., None])[..., 0] + apow * carry[s]
            carry[s] = u[:, -1:]
        out.append(u)
    return torch.cat(out, dim=-1)[:, :n]


def gammatone_cascade(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Four cascaded one-poles along the last axis of ``x [R, n]`` with the
    per-row pole ``a [R]``.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    `gammatone_cascade` kernel (float32, contiguous) or raises."""
    if x.dim() != 2 or a.shape != (x.shape[0],):
        raise ValueError(f"gammatone_cascade expects x [R, n] and a [R], got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    if x.device.type == "cpu":
        return gammatone_cascade_plain(x, a)
    if x.device.type != "cuda" or a.device != x.device:
        raise ValueError(f"gammatone_cascade: unsupported devices {x.device}, "
                         f"{a.device}")
    if x.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("gammatone_cascade kernel takes float32")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("gammatone_cascade: inputs must be contiguous")
    y = torch.empty_like(x)
    kernels.launch("gammatone_cascade", x.data_ptr(), a.data_ptr(),
                   y.data_ptr(), x.shape[0], x.shape[1],
                   torch.cuda.current_stream(x.device).cuda_stream)
    return y

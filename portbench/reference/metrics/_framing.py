"""Helpers shared by the metrics: exclusive-range framing (the
pystoi/pysiib convention: frames start at 0, hop, ... while start <
n - framelen; counterpart of `nelegan_tpu/metrics/_framing.py`), and the
leading batch dimension that stands in for the reference package's
`vmap`; host arrays to the device."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.device import resolve_device


def frame_exclusive(x: torch.Tensor, framelen: int, hop: int
                    ) -> torch.Tensor:
    """x [..., n] -> [..., nframes, framelen] (a copy)."""
    n = x.shape[-1]
    nframes = -(-(n - framelen) // hop) if n > framelen else 0
    idx = (torch.arange(nframes, device=x.device)[:, None] * hop
           + torch.arange(framelen, device=x.device)[None, :])
    return x[..., idx]


def as_rows(x: torch.Tensor, n_valid):
    """[n] or [B, n] -> ([B, n], n_valid as a [B] tensor on x's device or
    None, whether x was one signal)."""
    single = x.dim() == 1
    xb = x[None] if single else x
    if n_valid is not None:
        n_valid = torch.as_tensor(n_valid, device=x.device).reshape(-1)
        n_valid = n_valid.expand(xb.shape[0])
    return xb, n_valid, single


def const(a, like: torch.Tensor) -> torch.Tensor:
    """A host constant in `like`'s dtype on its device."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def on_device(x, device) -> torch.Tensor:
    """A tensor stays where it is; a host array goes to `device` (None:
    CUDA)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))

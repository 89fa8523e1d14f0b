"""Device selection for the port's entry points.

Entry points take ``device=None``, which means CUDA.  Without a GPU they
raise: the port never falls back to the CPU on its own.  A caller that wants
the CPU (the tests) passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent.  A CUDA
    device comes back with its index, as tensors report theirs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def disable_tf32() -> None:
    """Run float32 matmuls and convolutions in full float32.

    ``torch.backends.cudnn.allow_tf32`` defaults to True, which puts float32
    convolutions through TF32 (about three decimal digits); parity runs and
    the server turn it off so the generator keeps its float32 bar."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

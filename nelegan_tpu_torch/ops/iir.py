"""IIR filters: the first-order linear recurrence and its users.

Counterpart of `nelegan_tpu/ops/iir.py`.  The reference package evaluates
every recurrence with `jax.lax.associative_scan` (`one_pole`, the block
carries of `one_pole_blocked`, `linear_recurrence_2x2`).  Torch has no
associative scan, so each of them here is one call of `linrec`:

    y[n] = a[n] * y[n-1] + b[n]      along each row of [R, N], y[-1] = y0

A CUDA tensor launches the hand-written kernel `csrc/linrec.cu` (float32,
float64 or complex64, contiguous) or raises; a CPU tensor takes
`linrec_plain`, a loop over N vectorised over rows.  `linrec` is a
`torch.autograd.Function` on both: its backward is the same recurrence
from each row's end, the kernel's `linrec_bwd` launch on the card and
`linrec_backward_plain` on the CPU.
Higher orders decompose as in the reference package: the biquad's
denominator is its complex-conjugate pole pair, two complex one-poles; a
constant 2x2 system is diagonalised into two complex one-poles.
`one_pole_blocked` and `one_pole_cascade(blocked=True)`, the
TPU's matrix-unit form of the same recurrence, keep their signatures and
take the same route.

The closed-form impulse responses and FFT convolutions of the reference
package's ear model (`fft_causal_conv`, `one_pole_ir`, `gammatone_ir`,
`exp_sum_ir`, `one_pole_fft`) are plain torch.
"""
from __future__ import annotations

import numpy as np
import torch

from nelegan_tpu_torch import kernels

# the kernel's element types, by the code its `kind` argument takes
_KERNEL_KINDS = {torch.float32: 0, torch.complex64: 1, torch.float64: 2}


def linrec_plain(a: torch.Tensor, b: torch.Tensor,
                 y0: torch.Tensor | None = None) -> torch.Tensor:
    """The recurrence step by step: a [R] or [R, N], b [R, N], y0 [R] or
    None -> y [R, N]."""
    rows, n = b.shape
    y = torch.empty_like(b)
    s = torch.zeros(rows, dtype=b.dtype, device=b.device) if y0 is None \
        else y0.to(b.dtype)
    per_step = a.dim() == 2
    for i in range(n):
        s = (a[:, i] if per_step else a) * s + b[:, i]
        y[:, i] = s
    return y


def linrec_backward_plain(a: torch.Tensor, g: torch.Tensor, y: torch.Tensor,
                          y0: torch.Tensor | None = None, need_a: bool = True,
                          need_y0: bool = True):
    """The adjoint of `linrec` for the output's gradient g [R, N], in torch's
    convention for complex gradients: lam[n] = g[n] + conj(a[n+1]) lam[n+1]
    from the row's end, a loop over N vectorised over rows.  Returns (db,
    da, dy0): db = lam; da[n] = lam[n] conj(y[n-1]) with y[-1] = y0 (0 for
    None), summed over n when `a` is per row; dy0 = conj(a[0]) lam[0].  da
    and dy0 are None unless asked for."""
    rows, n = g.shape
    per_step = a.dim() == 2
    ca = a.conj()
    lam = torch.empty_like(g)
    s = torch.zeros(rows, dtype=g.dtype, device=g.device)
    for i in range(n - 1, -1, -1):
        if i + 1 < n:
            s = (ca[:, i + 1] if per_step else ca) * s + g[:, i]
        else:
            s = g[:, i].clone()
        lam[:, i] = s
    da = dy0 = None
    if need_a:
        first = torch.zeros_like(y[:, :1]) if y0 is None else y0[:, None]
        d = lam * torch.cat([first, y[:, :-1]], 1).conj()
        da = d if per_step else d.sum(1)
    if need_y0:
        dy0 = (ca[:, 0] if per_step else ca) * lam[:, 0]
    return lam, da, dy0


def _check_shapes(a, b, y0, name: str = "linrec") -> None:
    if b.dim() != 2 or a.shape not in (b.shape, b.shape[:1]) or (
            y0 is not None and y0.shape != b.shape[:1]):
        raise ValueError(f"{name} expects b [R, N], a [R, N] or [R], y0 [R]; "
                         f"got {tuple(b.shape)}, {tuple(a.shape)}, "
                         f"{None if y0 is None else tuple(y0.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_kernel_inputs(tensors, name: str) -> None:
    """Raise unless the tensors (of one dtype) are contiguous, on one CUDA
    device, and of a type the kernel takes."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: unsupported devices "
                         f"{[str(t.device) for t in tensors]}")
    if dtype not in _KERNEL_KINDS:
        raise TypeError(f"{name} kernel takes float32, float64 or complex64, "
                        f"got {dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _linrec_kernel(a, b, y0):
    y = torch.empty_like(b)
    kernels.launch("linrec", a.data_ptr(), b.data_ptr(), _ptr(y0),
                   y.data_ptr(), b.shape[0], b.shape[1],
                   _KERNEL_KINDS[b.dtype], int(a.dim() == 2), _stream(b))
    return y


def linrec_backward(a: torch.Tensor, g: torch.Tensor, y: torch.Tensor,
                    y0: torch.Tensor | None = None, need_a: bool = True,
                    need_y0: bool = True):
    """(db, da, dy0) of `linrec` for the output's gradient g, as
    `linrec_backward_plain` computes them.  A CPU tensor takes that loop; a
    CUDA tensor launches the `linrec_bwd` kernel (one launch, the recurrence
    from each row's end, da and dy0 written as it goes) or raises."""
    _check_shapes(a, g, y0, "linrec_backward")
    if y.shape != g.shape:
        raise ValueError(f"linrec_backward: y {tuple(y.shape)} and g "
                         f"{tuple(g.shape)} differ")
    need_y0 = need_y0 and y0 is not None
    if g.shape[1] == 0:
        return (torch.zeros_like(g), torch.zeros_like(a) if need_a else None,
                torch.zeros_like(y0) if need_y0 else None)
    if g.device.type == "cpu":
        return linrec_backward_plain(a, g, y, y0, need_a, need_y0)
    g = g.contiguous()
    tensors = [g, a, y] + ([] if y0 is None else [y0])
    if any(t.dtype != g.dtype for t in tensors):
        raise TypeError(f"linrec_bwd: one dtype expected, got "
                        f"{[t.dtype for t in tensors]}")
    _check_kernel_inputs(tensors, "linrec_bwd")
    db = torch.empty_like(g)
    da = torch.empty_like(a) if need_a else None
    dy0 = torch.empty_like(y0) if need_y0 else None
    kernels.launch("linrec_bwd", a.data_ptr(), g.data_ptr(), _ptr(y0),
                   y.data_ptr() if need_a else None, db.data_ptr(), _ptr(da),
                   _ptr(dy0), g.shape[0], g.shape[1],
                   _KERNEL_KINDS[g.dtype], int(a.dim() == 2), _stream(g))
    return db, da, dy0


class _Linrec(torch.autograd.Function):
    """`linrec` with its adjoint: the forward and the backward each one
    launch on the card, the plain loops on the CPU (run without a graph of
    their own, so the CPU's gradient comes from the formulas the kernel
    runs).  Once differentiable on both: no double backward and no
    forward-mode AD, which JAX's associative scan allows."""

    @staticmethod
    def forward(ctx, a, b, y0):
        y = linrec_plain(a, b, y0) if b.device.type == "cpu" \
            else _linrec_kernel(a, b, y0)
        ctx.save_for_backward(a, y, y0)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, y, y0 = ctx.saved_tensors
        need_a, need_b, need_y0 = ctx.needs_input_grad
        db, da, dy0 = linrec_backward(a, g, y, y0, need_a, need_y0)
        return da, db if need_b else None, dy0


def linrec(a: torch.Tensor, b: torch.Tensor,
           y0: torch.Tensor | None = None) -> torch.Tensor:
    """y[r, n] = a[r, n] y[r, n-1] + b[r, n] from y[r, -1] = y0[r] (0 when
    y0 is None); `a` is [R, N] (per step) or [R] (per row), of b's dtype.

    A CPU tensor takes `linrec_plain`.  A CUDA tensor launches the `linrec`
    kernel (float32, float64 or complex64, contiguous) or raises.
    Differentiable on both (`linrec_backward`)."""
    _check_shapes(a, b, y0)
    tensors = (a, b) if y0 is None else (a, b, y0)
    if any(t.dtype != b.dtype for t in tensors):
        raise TypeError(f"linrec: a, b and y0 must share one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.device.type == "cpu" for t in tensors):
        _check_kernel_inputs(tensors, "linrec")
    return _Linrec.apply(a, b, y0)


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def one_pole(x: torch.Tensor, a, axis: int = -1) -> torch.Tensor:
    """y[n] = x[n] + a*y[n-1] along `axis`; `a` a scalar or broadcastable
    to x (constant along `axis`: one value per row; else per step)."""
    xm = torch.movedim(x, axis, -1)
    lead, n = xm.shape[:-1], xm.shape[-1]
    b = xm.reshape(-1, n).contiguous()
    a_t = _as_tensor(a, x)
    if a_t.dim() > 0:
        a_t = torch.movedim(a_t.expand(x.shape), axis, -1)
    a_t = a_t.expand(xm.shape)
    if a_t.stride(-1) == 0 or n == 1:        # constant along the recurrence
        a_rows = a_t[..., 0].reshape(-1).contiguous()
    else:
        a_rows = a_t.reshape(-1, n).contiguous()
    y = linrec(a_rows, b)
    return torch.movedim(y.reshape(lead + (n,)), -1, axis)


def one_pole_blocked(x: torch.Tensor, a, block: int = 128) -> torch.Tensor:
    """y[n] = x[n] + a*y[n-1] along the last axis.  The reference package's
    matrix-unit form (`block`-sample Toeplitz products and a scan of the
    block carries); here the same recurrence through `linrec`, so `block`
    changes nothing."""
    del block
    return one_pole(x, a)


def one_pole_cascade(x: torch.Tensor, a, order: int, axis: int = -1,
                     blocked: bool | None = None) -> torch.Tensor:
    """`order` identical one-pole stages in cascade (both forms of the
    reference package are one `linrec` per stage here)."""
    del blocked
    y = x
    for _ in range(order):
        y = one_pole(y, a, axis=axis)
    return y


def _fft_len(n: int) -> int:
    """Smallest 2^k or 3*2^k >= 2n."""
    return _fft_len_ir(n, n)


def _fft_len_ir(n: int, ir_len: int) -> int:
    """Smallest 2^k or 3*2^k >= n + ir_len: the linear-convolution FFT size
    of a length-n signal against a length-ir_len kernel (the reference
    package's grid, so that both packages transform at the same sizes)."""
    need = n + ir_len
    m = 1
    while m < need:
        m *= 2
    m3 = 3 * (m // 4)
    return m3 if m3 >= need else m


def fft_causal_conv(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_k h[k] x[n-k] for a full-length h, broadcasting leading
    dims."""
    n = x.shape[-1]
    m = _fft_len(n)
    y = torch.fft.irfft(torch.fft.rfft(x, m) * torch.fft.rfft(h, m), m)
    return y[..., :n].to(x.dtype)


def one_pole_ir(a, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """h[k] = a^k as exp(k log|a|) (underflows cleanly), with the sign
    alternating for a negative pole."""
    a = torch.as_tensor(a, dtype=dtype, device=device)
    k = torch.arange(n, dtype=dtype, device=a.device)
    mag = torch.exp(k * torch.log(torch.clamp_min(a.abs(), 1e-30)))
    alt = 1.0 - 2.0 * (torch.arange(n, device=a.device) % 2).to(dtype)
    sign = torch.where(a < 0, alt, torch.ones_like(alt))
    return (mag * sign).to(dtype)


def gammatone_ir(a, n: int, dtype=torch.float32, device=None
                 ) -> torch.Tensor:
    """Impulse response of [1, 4a, 4a^2] / (1 - a z^-1)^4 in the log domain:
    d[k] = C(k+3, 3) a^k, h[k] = d[k] + 4a d[k-1] + 4a^2 d[k-2]."""
    a = torch.as_tensor(a, dtype=dtype, device=device)
    k = torch.arange(n, dtype=dtype, device=a.device)
    log_a = torch.log(torch.clamp_min(a, 1e-30))
    log_poly = (torch.log1p(k) + torch.log(k + 2.0) + torch.log(k + 3.0)
                - float(np.log(6.0)))
    d = torch.exp(k * log_a + log_poly)
    pad = torch.zeros_like(d[..., :2])
    d1 = torch.cat([pad[..., :1], d[..., :-1]], -1)
    d2 = torch.cat([pad, d[..., :-2]], -1)
    return (d + 4.0 * a * d1 + 4.0 * (a * a) * d2).to(dtype)


def exp_sum_ir(lams, weights, n: int, dtype=torch.float32, device=None
               ) -> torch.Tensor:
    """h[k] = sum_i weights[i] * lams[i]^k for real poles."""
    k = torch.arange(n, dtype=dtype, device=device)
    alt = 1.0 - 2.0 * (torch.arange(n, device=device) % 2).to(dtype)
    h = torch.zeros(n, dtype=dtype, device=device)
    for lam, w in zip(lams, weights):
        lam = float(np.real_if_close(lam))
        # clamped as in one_pole_ir: a zero pole gives [w, 0, 0, ...]
        mag = float(np.log(max(abs(lam), 1e-30)))
        h = h + float(np.real(w)) * torch.exp(k * mag) * (
            1.0 if lam >= 0 else alt)
    return h


def one_pole_fft(x: torch.Tensor, a) -> torch.Tensor:
    return fft_causal_conv(x, one_pole_ir(a, x.shape[-1], x.dtype, x.device))


def fir(x: torch.Tensor, taps, axis: int = -1) -> torch.Tensor:
    """y[n] = sum_k taps[k] x[n-k] (causal, zero initial state)."""
    taps = _as_tensor(taps, x)
    xm = torch.movedim(x, axis, -1)
    y = taps[0] * xm
    shifted = xm
    for k in range(1, taps.shape[0]):
        shifted = torch.cat([torch.zeros_like(shifted[..., :1]),
                             shifted[..., :-1]], -1)
        y = y + taps[k] * shifted
    return torch.movedim(y, -1, axis)


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def linear_recurrence_2x2(m, v: torch.Tensor) -> torch.Tensor:
    """s[n] = m[n] @ s[n-1] + v[n] with s in R^2; m [T, 2, 2] or a constant
    [2, 2], v [T, 2] -> s [T, 2].

    On the CPU a per-step loop.  On the card m must be constant: its
    eigendecomposition m = P diag(l) P^-1 turns the system into two complex
    one-poles, z_i[n] = l_i z_i[n-1] + (P^-1 v[n])_i, one `linrec` launch,
    and s = Re(P z).  The eigendecomposition is taken on the host, so there
    a gradient passes to v but not to m: an m that requires one raises."""
    m = torch.as_tensor(m, dtype=v.dtype, device=v.device)
    if v.device.type != "cpu" and m.requires_grad:
        raise ValueError("linear_recurrence_2x2 on the card takes no "
                         "gradient with respect to m (its eigenvectors are "
                         "found on the host); m requires grad")
    if v.device.type == "cpu":
        mm = m.expand(v.shape[:-1] + (2, 2))
        s = torch.zeros(2, dtype=v.dtype)
        out = torch.empty_like(v)
        for i in range(v.shape[0]):
            s = mm[i] @ s + v[i]
            out[i] = s
        return out
    if m.dim() != 2:
        raise ValueError("linear_recurrence_2x2 on the card takes a constant "
                         "[2, 2] matrix (its kernel is a one-pole scan)")
    m_np = m.detach().cpu().double().numpy()
    lam, p = np.linalg.eig(m_np)
    if np.linalg.cond(p) > 1e6:
        raise ValueError("linear_recurrence_2x2: the matrix is not "
                         "diagonalisable")
    cdt = _complex_of(v.dtype)
    p_inv = torch.as_tensor(np.linalg.inv(p), dtype=cdt, device=v.device)
    b = (v.to(cdt) @ p_inv.T).T.contiguous()               # [2, T]
    z = linrec(torch.as_tensor(lam, dtype=cdt, device=v.device), b)
    s = z.T @ torch.as_tensor(p, dtype=cdt, device=v.device).T
    return s.real.to(v.dtype)


def biquad(x: torch.Tensor, b, a, axis: int = -1) -> torch.Tensor:
    """2nd-order IIR y = lfilter(b, a, x), a = [1, a1, a2], b = [b0, b1, b2]:
    the FIR numerator, then the denominator as its complex-conjugate pole
    pair (two complex one-poles) when the poles are complex, else as two
    real one-poles."""
    b = list(b) + [0.0] * (3 - len(b))
    roots = np.roots(np.asarray(a, np.float64))
    t = fir(x, b, axis=axis)
    if np.iscomplexobj(roots) and abs(roots[0].imag) > 1e-12:
        p = complex(roots[0])
        y = one_pole(t.to(_complex_of(x.dtype)), p, axis=axis)
        y = one_pole(y, p.conjugate(), axis=axis)
        return y.real.to(x.dtype)
    y = one_pole(t, float(roots[0].real), axis=axis)
    return one_pole(y, float(roots[1].real), axis=axis)

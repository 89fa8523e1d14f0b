"""IIR filters over the first-order linear recurrence, for the reference.

A frozen copy of the port's `ops/iir.py` with its `linrec` replaced: here
the recurrence runs on the host in float64 (`scipy.signal.lfilter`), so the
reference shares no code with the port's `linrec` kernel or its plain
loop.  The biquad's denominator is its complex-conjugate pole pair, two
complex one-poles; a constant 2x2 system is diagonalised into two complex
one-poles; the ear model's impulse responses and FFT convolutions are plain
torch.
"""
from __future__ import annotations

import numpy as np
import torch



def linrec(a: torch.Tensor, b: torch.Tensor,
           y0: torch.Tensor | None = None) -> torch.Tensor:
    """y[r, n] = a[r, n] y[r, n-1] + b[r, n] from y[r, -1] = y0[r] (0 when
    y0 is None); `a` is [R, N] (per step) or [R] (per row).

    The benchmark's reference form: on the host in float64 (complex128),
    one `scipy.signal.lfilter` a row for a per-row `a`, the step loop for a
    per-step one, cast back to b's dtype and device.  No gradient."""
    from scipy.signal import lfilter
    wide = torch.complex128 if b.is_complex() else torch.float64
    a64 = a.detach().to("cpu", wide).numpy()
    b64 = b.detach().to("cpu", wide).numpy()
    s0 = (np.zeros(b64.shape[0], b64.dtype) if y0 is None
          else y0.detach().to("cpu", wide).numpy())
    if a64.ndim == 2:
        y = np.empty_like(b64)
        s = s0
        for i in range(b64.shape[1]):
            s = a64[:, i] * s + b64[:, i]
            y[:, i] = s
    else:
        y = np.stack([lfilter([1.0], [1.0, -a64[r]], b64[r],
                              zi=[a64[r] * s0[r]])[0]
                      for r in range(b64.shape[0])]) if b64.shape[0] else b64
    return torch.from_numpy(np.ascontiguousarray(y)).to(b.device, b.dtype)


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

"""Fused feed-forward with its residual (kernel 2), its backward (kernel 4)
and the two joined as an autograd Function, in both forms:

    pre-norm (CrossFormer):  x + fc2(GELU(fc1(LN(x))))
    post-norm (SwinV2/FuXi): x + LN(fc2(GELU(fc1(x))))

The port of credit_tpu/ops/pallas_ff.py `fused_ff`, `fused_ff_bwd` and
`fused_ff_diff`. `fused_ff` and `fused_ff_bwd` launch the hand-written CUDA
kernels (`csrc/fused_ff.cu`, `csrc/fused_ff_bwd.cu`) for CUDA tensors and run
`fused_ff_plain` / `fused_ff_bwd_plain` for CPU tensors. As in the TPU
wrapper, the LN parameters and biases are rounded to x's dtype first; LN
statistics and every product accumulate in f32; LN(x) and GELU's output are
cast to x's dtype before the next product; post-norm takes the LN of fc2's
f32 output (b2 included) before its one cast; the residual is added in x's
dtype. The backward keeps the rounding points of the TPU kernel
(pallas_ff.py:239-294): y = LN(x) (pre-norm) or x, a = GELU(h1), the
cotangent of fc2's output and dh1 are in x's dtype where they enter a
product, while the LN statistics, Phi(h1), the pdf and every sum stay f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from credit_torch import _build

EPS = 1e-5
MAX_C = 1024  # widest channel count the CUDA kernel's register plan takes
SQRT1_2 = 0.7071067811865476
INV_SQRT_2PI = 0.3989422804014327


def _stats(v: torch.Tensor):
    """(v - mean) * rstd and rstd over the last axis, f32: the mean, then the
    mean of squared deviations, as the TPU kernel takes them."""
    mean = v.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((v - mean) ** 2).mean(-1, keepdim=True) + EPS)
    return (v - mean) * rstd, rstd


def _ln(v: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _stats(v)[0] * g + b


def fused_ff_plain(x, g, b, w1, b1, w2, b2, post_norm: bool = False) -> torch.Tensor:
    """The same function in plain PyTorch, for x (..., C)."""
    dt = x.dtype
    g, b, b1, b2 = (t.to(dt).float() for t in (g, b, b1, b2))
    y = x if post_norm else _ln(x.float(), g, b).to(dt)
    h = y.float() @ w1.to(dt).float() + b1
    h = F.gelu(h).to(dt)
    o = h.float() @ w2.to(dt).float() + b2
    if post_norm:
        o = _ln(o, g, b)
    return x + o.to(dt)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra == 0:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, extra]
    return F.pad(t, pad)


def fused_ff(x, g, b, w1, b1, w2, b2, post_norm: bool = False) -> torch.Tensor:
    """x (M, C) or (B, H, W, C); g, b, b2 (C,); w1 (C, Hd); b1 (Hd,); w2 (Hd, C).
    post_norm selects the SwinV2 form."""
    if x.device.type == "cpu":
        return fused_ff_plain(x, g, b, w1, b1, w2, b2, post_norm)
    c = x.shape[-1]
    hidden = w1.shape[1]
    if c % 8 or c > MAX_C:
        raise ValueError(f"fused_ff: the CUDA kernel takes C % 8 == 0 and C <= {MAX_C}, got {c}")
    code = _build.dtype_code(x.dtype)
    x2 = x.contiguous().reshape(-1, c)
    m = x2.shape[0]
    prm = [t.to(x.dtype) for t in (g, b, w1, b1, w2, b2)]
    cpad = c
    if x.dtype == torch.bfloat16:
        # the warps tile a width of 128, 256, 512 or 1024: zero-pad C to it
        # and the hidden width to the kernel's chunk (zeros add nothing:
        # GELU(0) = 0; the post-norm LN divides by the true C and leaves the
        # padded columns out)
        cpad = _build.function("credit_fused_ff_width", [ctypes.c_int])(c)
        chunk = _build.function("credit_fused_ff_chunk", [ctypes.c_int])(cpad)
        hpad = -(-hidden // chunk) * chunk
        g, b, w1, b1, w2, b2 = prm
        prm = [_pad_to(g, 0, cpad), _pad_to(b, 0, cpad),
               _pad_to(_pad_to(w1, 0, cpad), 1, hpad), _pad_to(b1, 0, hpad),
               _pad_to(_pad_to(w2, 0, hpad), 1, cpad), _pad_to(b2, 0, cpad)]
        hidden = hpad
    # the kernel copies rows in 16-byte vectors
    x2, *prm = (t if t.data_ptr() % 16 == 0 else t.clone()
                for t in [x2] + [t.contiguous() for t in prm])
    out = torch.empty_like(x2)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("credit_fused_ff", [p] * 8 + [i] * 6 + [p])
    err = fn(x2.data_ptr(), *(t.data_ptr() for t in prm), out.data_ptr(), code,
             m, c, cpad, hidden, int(post_norm), _build.stream_ptr())
    _build.check(err, "credit_fused_ff")
    fused_ff.launches += 1
    return out.reshape(x.shape)


fused_ff.launches = 0


# ------------------------------------------------------------------ backward
def _ln_bwd(d: torch.Tensor, vhat: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    """The input gradient of an LN whose normalised output vhat received d
    (scale applied): rstd (d - mean(d) - vhat mean(d vhat))."""
    return rstd * (d - d.mean(-1, keepdim=True) - vhat * (d * vhat).mean(-1, keepdim=True))


def fused_ff_bwd_plain(x, ct, g, b, w1, b1, w2, b2, post_norm: bool = False):
    """The backward in plain PyTorch: (dx, dg, db, dw1, db1, dw2, db2) with
    dx in x's dtype and the parameter gradients summed over rows in f32."""
    dt = x.dtype
    c = x.shape[-1]
    xf = x.reshape(-1, c).float()
    ctf = ct.reshape(-1, c).to(dt).float()
    g, b, b1, b2 = (t.to(dt).float() for t in (g, b, b1, b2))
    w1, w2 = w1.to(dt).float(), w2.to(dt).float()
    if post_norm:
        y = xf
    else:
        xhat, rstd = _stats(xf)
        y = (xhat * g + b).to(dt).float()
    h1 = y @ w1 + b1
    phi = 0.5 * (1.0 + torch.erf(h1 * SQRT1_2))
    a = (h1 * phi).to(dt).float()
    if post_norm:  # push ct through the output LN first; b2 moves its statistics
        ohat, rstd_o = _stats(a @ w2 + b2)
        dg, db = (ctf * ohat).sum(0), ctf.sum(0)
        do2 = _ln_bwd(ctf * g, ohat, rstd_o)
        db2 = do2.sum(0)
        do2 = do2.to(dt).float()
    else:
        do2 = ctf
        db2 = ctf.sum(0)
    dw2 = a.T @ do2
    da = do2 @ w2.T
    dh1 = da * (phi + h1 * torch.exp(-0.5 * h1 * h1) * INV_SQRT_2PI)
    dh1r = dh1.to(dt).float()
    dw1 = y.T @ dh1r
    dy = dh1r @ w1.T
    if post_norm:
        dx = ctf + dy
    else:
        dg, db = (dy * xhat).sum(0), dy.sum(0)
        dx = ctf + _ln_bwd(dy * g, xhat, rstd)
    return dx.to(dt).reshape(x.shape), dg, db, dw1, dh1.sum(0), dw2, db2


def fused_ff_bwd(x, ct, g, b, w1, b1, w2, b2, post_norm: bool = False):
    """Backward of `fused_ff` at x (M, C) or (B, H, W, C) with cotangent ct
    of x's shape. Returns (dx, dg, db, dw1, db1, dw2, db2): dx in x's dtype,
    the rest f32."""
    if x.device.type == "cpu":
        return fused_ff_bwd_plain(x, ct, g, b, w1, b1, w2, b2, post_norm)
    c = x.shape[-1]
    hidden = w1.shape[1]
    if c % 8 or hidden % 8:
        raise ValueError(f"fused_ff_bwd: the CUDA kernel takes C and hidden % 8 == 0, "
                         f"got {c}, {hidden}")
    if ct.shape != x.shape:
        raise ValueError(f"fused_ff_bwd: ct {tuple(ct.shape)} != x {tuple(x.shape)}")
    code = _build.dtype_code(x.dtype)
    x2 = x.contiguous().reshape(-1, c)
    m = x2.shape[0]
    # b2 shifts the post-norm LN's statistics (the pre-norm kernel ignores it)
    ins = [x2, ct.to(x.dtype).contiguous().reshape(-1, c)] + [
        t.to(x.dtype).contiguous() for t in (g, b, w1, b1, w2, b2)]
    # the kernels read rows in 16-byte vectors
    ins = [t if t.data_ptr() % 16 == 0 else t.clone() for t in ins]
    p, i = ctypes.c_void_p, ctypes.c_int
    nbytes = _build.function("credit_fused_ff_bwd_workspace", [i] * 4,
                             ctypes.c_longlong)(code, m, c, hidden)
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x2)
    dln = torch.empty((3, c), **f32)  # dg | db | db2
    dw1, db1, dw2 = (torch.empty((c, hidden), **f32), torch.empty(hidden, **f32),
                     torch.empty((hidden, c), **f32))
    fn = _build.function("credit_fused_ff_bwd", [p] * 14 + [i] * 5 + [p])
    err = fn(*(t.data_ptr() for t in ins),
             *(t.data_ptr() for t in (dx, dln, dw1, db1, dw2, work)),
             code, m, c, hidden, int(post_norm), _build.stream_ptr())
    _build.check(err, "credit_fused_ff_bwd")
    fused_ff_bwd.launches += 1
    return dx.reshape(x.shape), dln[0], dln[1], dw1, db1, dw2, dln[2]


fused_ff_bwd.launches = 0


class _FusedFF(torch.autograd.Function):
    """Forward: kernel 2. Saves x and the parameters only; the backward
    (kernel 4) recomputes the LN, fc1, GELU (and post-norm fc2) from them."""

    @staticmethod
    def forward(ctx, x, g, b, w1, b1, w2, b2, post_norm):
        ctx.save_for_backward(x, g, b, w1, b1, w2, b2)
        ctx.post_norm = post_norm
        return fused_ff(x, g, b, w1, b1, w2, b2, post_norm)

    @staticmethod
    def backward(ctx, ct):
        x, *prm = ctx.saved_tensors
        dx, *grads = fused_ff_bwd(x, ct, *prm, post_norm=ctx.post_norm)
        return (dx, *(d.to(p.dtype) for d, p in zip(grads, prm)), None)


def fused_ff_diff(x, g, b, w1, b1, w2, b2, post_norm: bool = False) -> torch.Tensor:
    """Differentiable `fused_ff`: kernel 2 forward, kernel 4 backward, in
    either form. The parameter gradients come back in each parameter's own
    dtype."""
    return _FusedFF.apply(x, g, b, w1, b1, w2, b2, bool(post_norm))

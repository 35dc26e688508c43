"""Fused pre-norm feed-forward with its residual (kernel 2):
x + fc2(GELU(fc1(LN(x)))).

The port of credit_tpu/ops/pallas_ff.py `fused_ff` (pre-norm). `fused_ff`
launches the hand-written CUDA kernel (`csrc/fused_ff.cu`) for CUDA tensors
and runs `fused_ff_plain` for CPU tensors. As in the TPU wrapper, the LN
parameters and biases are rounded to x's dtype first; LN statistics and both
products accumulate in f32; LN(x) and GELU's output are cast to x's dtype
before the next product; the residual is added in x's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from credit_torch import _build

EPS = 1e-5
MAX_C = 1024  # widest channel count the CUDA kernel's register plan takes


def fused_ff_plain(x, g, b, w1, b1, w2, b2) -> torch.Tensor:
    """The same function in plain PyTorch, for x (..., C)."""
    dt = x.dtype
    g, b, b1, b2 = (t.to(dt).float() for t in (g, b, b1, b2))
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + EPS) * g + b).to(dt)
    h = y.float() @ w1.to(dt).float() + b1
    h = F.gelu(h).to(dt)
    o = h.float() @ w2.to(dt).float() + b2
    return x + o.to(dt)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra == 0:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, extra]
    return F.pad(t, pad)


def fused_ff(x, g, b, w1, b1, w2, b2) -> torch.Tensor:
    """x (M, C) or (B, H, W, C); g, b, b2 (C,); w1 (C, Hd); b1 (Hd,); w2 (Hd, C)."""
    if x.device.type == "cpu":
        return fused_ff_plain(x, g, b, w1, b1, w2, b2)
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
        # GELU(0) = 0)
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
    fn = _build.function("credit_fused_ff", [p] * 8 + [i] * 5 + [p])
    err = fn(x2.data_ptr(), *(t.data_ptr() for t in prm), out.data_ptr(), code,
             m, c, cpad, hidden, _build.stream_ptr())
    _build.check(err, "credit_fused_ff")
    fused_ff.launches += 1
    return out.reshape(x.shape)


fused_ff.launches = 0

"""Windowed multi-head attention with one shared (T, T) f32 bias (kernel 3).

The port of credit_tpu/ops/pallas_attention.py `fused_window_attention`.
`fused_window_attention` launches the hand-written CUDA kernel
(`csrc/window_attention.cu`) for CUDA tensors and runs
`fused_window_attention_plain` for CPU tensors. Numerics follow the TPU
kernel: q scaled in its own dtype, f32 scores plus the f32 bias, a safe
softmax in f32 with exact division, probabilities cast to v's dtype, P.V
accumulated in f32, output in the input dtype.

`fused_window_attention_diff` makes it differentiable. credit_tpu has no
Pallas backward for attention (its training differentiates the jnp route
with XLA's autodiff), so the backward here is autograd of the plain version,
recomputed from the saved q, k, v and bias; the forward stays on the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from credit_torch import _build


def fused_window_attention_plain(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """The same function in plain PyTorch. q, k, v (B, nWin, T, heads*dh)."""
    b, nwin, t, inner = q.shape
    dh = inner // num_heads

    def split(z):  # (b, n, t, h*dh) -> (b, n, h, t, dh)
        return z.reshape(b, nwin, t, num_heads, dh).transpose(2, 3)

    qs = split(q * torch.tensor(dh ** -0.5, dtype=q.dtype))
    sim = qs.float() @ split(k).float().transpose(-1, -2) + bias.float()
    sim = sim - sim.amax(dim=-1, keepdim=True)
    p = torch.exp(sim)
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = (p.float() @ split(v).float()).to(q.dtype)
    return out.transpose(2, 3).reshape(b, nwin, t, inner)


def fused_window_attention(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """q, k, v: (B, nWin, T, heads*dh), each with unit stride over its last
    dim and one token stride (views of one fused qkv projection are taken
    as they are); bias (T, T). Returns a new (B, nWin, T, heads*dh). bf16
    windows of up to 128 tokens with heads of 16, 32 or 64 run on the
    tensor cores; every other shape whose k and v fit in shared memory on
    the FMA kernel (csrc/window_attention.cu)."""
    if q.device.type == "cpu":
        return fused_window_attention_plain(q, k, v, bias, num_heads)
    b, nwin, t, inner = q.shape
    dh = inner // num_heads
    if dh * num_heads != inner:
        raise ValueError(f"fused_window_attention: {inner} channels do not split into "
                         f"{num_heads} heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("fused_window_attention: q, k, v must share a dtype")

    def token_stride(z):
        # rows of (B*nWin*T) tokens, one stride, unit stride inside a row
        if z.shape != q.shape:
            raise ValueError("fused_window_attention: q, k, v shapes differ")
        if z.stride(-1) != 1 or z.stride(-3) != t * z.stride(-2) or z.stride(0) != nwin * t * z.stride(-2):
            z = z.contiguous()
        return z, z.stride(-2)

    (q, sq), (k, sk), (v, sv) = token_stride(q), token_stride(k), token_stride(v)
    if not sq == sk == sv:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        sq = inner
    # f32, zero-padded to a multiple of 16 each way (the bf16 kernel reads
    # whole 16-key tiles of it)
    tp = -(-t // 16) * 16
    bias = F.pad(bias.to(device=q.device, dtype=torch.float32), (0, tp - t, 0, tp - t))
    out = torch.empty((b, nwin, t, inner), dtype=q.dtype, device=q.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("credit_window_attention",
                         [p] * 5 + [i] * 7 + [ctypes.c_float, p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
             _build.dtype_code(q.dtype), b * nwin, num_heads, t, dh, sq, inner,
             float(torch.tensor(dh ** -0.5, dtype=torch.float32)), _build.stream_ptr())
    _build.check(err, "credit_window_attention")
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0


class _WindowAttention(torch.autograd.Function):
    """Forward: kernel 3. Backward: autograd of the plain version,
    recomputed from the saved inputs (the gradient of the bias flows on into
    the dynamic position bias)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.num_heads = num_heads
        return fused_window_attention(q, k, v, bias, num_heads)

    @staticmethod
    def backward(ctx, gout):
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = fused_window_attention_plain(*ins, ctx.num_heads)
            grads = iter(torch.autograd.grad(out, [t for t in ins if t.requires_grad], gout))
        return (*(next(grads) if n else None for n in need), None)


def fused_window_attention_diff(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """Differentiable `fused_window_attention` (see the module note)."""
    return _WindowAttention.apply(q, k, v, bias, num_heads)

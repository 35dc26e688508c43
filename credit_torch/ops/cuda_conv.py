"""Stride-1 VALID 2-D convolution, NHWC x HWIO -> NHWC (kernel 1), its
weight gradient (kernel 5) and the two joined as an autograd Function.

The port of credit_tpu/ops/pallas_conv.py `conv2d_valid`, `conv2d_wgrad`
and their VJP `_bwd`. `conv2d_valid` and `conv2d_wgrad` launch the
hand-written CUDA kernels (`csrc/conv_valid.cu`, `csrc/conv_wgrad.cu`) for
CUDA tensors and run `conv2d_valid_plain` / `conv2d_wgrad_plain` for CPU
tensors. All accumulate in f32; the conv returns the input dtype, the weight
gradient f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from credit_torch import _build

MAX_TAPS = 8  # kernels taller or wider run their taps in groups of at most 8x8


def conv2d_valid_plain(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: one f32 GEMM per kernel tap
    (products of bf16 values are exact in f32, so this is f32 accumulation
    in every dtype)."""
    n, hp, wp, cin = x.shape
    kh, kw, _, cout = kernel.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    xf = x.float()
    kf = kernel.float()
    out = torch.zeros((n, ho, wo, cout), dtype=torch.float32, device=x.device)
    for di in range(kh):
        for dj in range(kw):
            out += xf[:, di:di + ho, dj:dj + wo, :] @ kf[di, dj]
    return out.to(x.dtype)


def conv2d_valid(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x (N, Hp, Wp, Cin), kernel (kh, kw, Cin, Cout) -> (N, Hp-kh+1, Wp-kw+1, Cout),
    any kh and kw (the CUDA kernel runs taps in groups of at most 8x8).
    A launch adds one to `conv2d_valid.launches`, or to
    `conv2d_valid.launches_grouped` for a kernel beyond 8x8."""
    if x.device.type == "cpu":
        return conv2d_valid_plain(x, kernel)
    n, hp, wp, cin = x.shape
    kh, kw, kcin, cout = kernel.shape
    if kcin != cin or hp < kh or wp < kw:
        raise ValueError(f"conv2d_valid: x {tuple(x.shape)} and kernel {tuple(kernel.shape)} do not fit")
    if kernel.dtype != x.dtype or kernel.device != x.device:
        raise TypeError("conv2d_valid: kernel must match x's dtype and device")
    # contiguous, with 16-byte aligned rows for the kernel's vector copies
    x, kernel = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x.contiguous(), kernel.contiguous()))
    out = torch.empty((n, hp - kh + 1, wp - kw + 1, cout), dtype=x.dtype, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("credit_conv_valid", [p, p, p] + [i] * 8 + [p])
    err = fn(x.data_ptr(), kernel.data_ptr(), out.data_ptr(), _build.dtype_code(x.dtype),
             n, hp, wp, cin, kh, kw, cout, _build.stream_ptr())
    _build.check(err, "credit_conv_valid")
    # counted apart: kernels beyond 8x8 run in tap groups (bf16: its own kernel)
    if kh > MAX_TAPS or kw > MAX_TAPS:
        conv2d_valid.launches_grouped += 1
    else:
        conv2d_valid.launches += 1
    return out


conv2d_valid.launches = 0
conv2d_valid.launches_grouped = 0


# ------------------------------------------------------------ weight gradient
def conv2d_wgrad_plain(x: torch.Tensor, gy: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """gk[di, dj, c, o] = sum_{n,y,x} x[n, y+di, x+dj, c] gy[n, y, x, o] in
    plain PyTorch: one f32 GEMM per tap, gy rounded to x's dtype first."""
    n, hp, wp, cin = x.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    cout = gy.shape[-1]
    xf = x.float()
    g2 = gy.to(x.dtype).float().reshape(-1, cout)
    taps = [xf[:, di:di + ho, dj:dj + wo, :].reshape(-1, cin).T @ g2
            for di in range(kh) for dj in range(kw)]
    return torch.stack(taps).reshape(kh, kw, cin, cout)


def conv2d_wgrad(x: torch.Tensor, gy: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Weight gradient of the VALID conv: x (N, Hp, Wp, Cin), gy (N, Hp-kh+1,
    Wp-kw+1, Cout) -> f32 (kh, kw, Cin, Cout); gy is rounded to x's dtype."""
    if x.device.type == "cpu":
        return conv2d_wgrad_plain(x, gy, kh, kw)
    n, hp, wp, cin = x.shape
    cout = gy.shape[-1]
    if gy.shape != (n, hp - kh + 1, wp - kw + 1, cout) or kh < 1 or kw < 1:
        raise ValueError(f"conv2d_wgrad: x {tuple(x.shape)}, gy {tuple(gy.shape)} and a "
                         f"{kh}x{kw} kernel do not fit")
    code = _build.dtype_code(x.dtype)
    x, gy = (t if t.data_ptr() % 16 == 0 else t.clone()
             for t in (x.contiguous(), gy.to(x.dtype).contiguous()))
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [n, hp, wp, cin, kh, kw, cout]
    # per-split partial sums, added in a fixed order by the entry's second pass
    nbytes = _build.function("credit_conv_wgrad_workspace", [i] * 8,
                             ctypes.c_longlong)(code, *args)
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    gk = torch.empty((kh, kw, cin, cout), dtype=torch.float32, device=x.device)
    fn = _build.function("credit_conv_wgrad", [p] * 4 + [i] * 8 + [p])
    err = fn(x.data_ptr(), gy.data_ptr(), gk.data_ptr(), work.data_ptr(), code, *args,
             _build.stream_ptr())
    _build.check(err, "credit_conv_wgrad")
    conv2d_wgrad.launches += 1
    return gk


conv2d_wgrad.launches = 0


class _ConvValid(torch.autograd.Function):
    """Forward: kernel 1. Backward as credit_tpu's `_bwd`: gx is kernel 1
    itself on gy padded by (kh-1, kw-1) with the kernel flipped and in/out
    swapped (a full correlation), gk is kernel 5."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return conv2d_valid(x, kernel)

    @staticmethod
    def backward(ctx, gy):
        x, kernel = ctx.saved_tensors
        kh, kw = kernel.shape[0], kernel.shape[1]
        gx = gk = None
        if ctx.needs_input_grad[0]:
            k_flip = kernel.flip((0, 1)).transpose(2, 3)
            gy_pad = F.pad(gy, (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
            gx = conv2d_valid(gy_pad, k_flip)
        if ctx.needs_input_grad[1]:
            gk = conv2d_wgrad(x, gy, kh, kw).to(kernel.dtype)
        return gx, gk


def conv2d_valid_diff(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Differentiable `conv2d_valid` (kernel 1 forward and input gradient,
    kernel 5 weight gradient); the input gradient is skipped when x needs
    none."""
    return _ConvValid.apply(x, kernel)

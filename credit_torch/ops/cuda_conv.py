"""Stride-1 VALID 2-D convolution, NHWC x HWIO -> NHWC (kernel 1).

The port of credit_tpu/ops/pallas_conv.py `conv2d_valid`. `conv2d_valid`
launches the hand-written CUDA kernel (`csrc/conv_valid.cu`) for CUDA
tensors and runs `conv2d_valid_plain` for CPU tensors. Both accumulate in
f32 and return the input dtype.
"""

from __future__ import annotations

import ctypes

import torch

from credit_torch import _build

MAX_K = 8  # largest kernel height/width the CUDA kernel's tiling takes


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
    """x (N, Hp, Wp, Cin), kernel (kh, kw, Cin, Cout) -> (N, Hp-kh+1, Wp-kw+1, Cout)."""
    if x.device.type == "cpu":
        return conv2d_valid_plain(x, kernel)
    n, hp, wp, cin = x.shape
    kh, kw, kcin, cout = kernel.shape
    if kcin != cin or hp < kh or wp < kw:
        raise ValueError(f"conv2d_valid: x {tuple(x.shape)} and kernel {tuple(kernel.shape)} do not fit")
    if kh > MAX_K or kw > MAX_K:
        raise ValueError(f"conv2d_valid: the CUDA kernel takes kh, kw <= {MAX_K}, got {kh}x{kw}")
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
    conv2d_valid.launches += 1
    return out


conv2d_valid.launches = 0

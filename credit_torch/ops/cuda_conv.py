"""Stride-1 VALID 2-D convolution, NHWC x HWIO -> NHWC (kernel 2), its
weight gradient (kernel 5) and the two joined as an autograd Function.

The port of credit_tpu/ops/pallas_conv.py `conv2d_valid`, `conv2d_wgrad`
and their VJP `_bwd`. `conv2d_valid` and `conv2d_wgrad` launch the
hand-written CUDA kernels (`csrc/conv_valid.cu`, `csrc/conv_wgrad.cu`) for
CUDA tensors and run `conv2d_valid_plain` / `conv2d_wgrad_plain` for CPU
tensors. All accumulate in f32; the conv returns the input dtype, the weight
gradient f32.

The bf16 kernels load their tiles by TMA, whose tensor maps take 16-byte
strides: where Cin or Cout is not a multiple of 8 the wrappers zero-pad the
channels (a copy of the inputs, and of the output cut back) before the
launch. `conv_plan` and `wgrad_plan` pick each launch's tiles and split
from the shapes alone, once per shape (cached: the split search
costs host time a training step cannot spare).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from credit_torch import _build

BN_CHOICES = (64, 128, 192, 256)  # bf16: output channels a block (wgmma N)
TILE_WIDTHS = (16, 32, 64)  # bf16 conv: output columns a block (128 pixels)
SEG_WIDTHS = (64, 32, 16)  # bf16 weight gradient: pixel columns a K step (64 pixels)
CHANNEL_ALIGN = 8  # bf16: TMA strides are multiples of 16 bytes
SMS = 132  # an H100's multiprocessors, for plans made without a card
# weight-gradient split model: a block's rate on one SM, and the rate the
# split partials are written and summed at
SM_FLOPS = 4.5e12
HBM_BYTES_PER_S = 3.0e12


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _pad_last2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """t zero-padded to `rows` x `cols` in its last two dims."""
    dr, dc = rows - t.shape[-2], cols - t.shape[-1]
    return F.pad(t, (0, dc, 0, dr)) if dr or dc else t


def _pad_last(t: torch.Tensor, size: int) -> torch.Tensor:
    return F.pad(t, (0, size - t.shape[-1])) if t.shape[-1] != size else t


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, its base 16-byte aligned (TMA and vector copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@dataclass(frozen=True)
class ConvPlan:
    """What one launch of kernel 2 is told: the channels it sees (bf16:
    padded to multiples of 8), BN output channels and TW output columns a
    block (bf16: 128 // TW rows of them). The kernel's entry derives its
    grid from these."""

    cin: int
    cout: int
    bn: int
    tw: int


@functools.lru_cache(maxsize=1024)
def conv_plan(dtype: torch.dtype, n: int, hp: int, wp: int, cin: int, kh: int, kw: int,
              cout: int, sms: int = SMS) -> ConvPlan:
    """bf16: the tile width that wastes the fewest output pixels (16 on a
    tie), then `wgmma_bn`'s BN. f32: the FMA kernel's fixed 8 x 16 pixels
    x 64 channels."""
    ho, wo = hp - kh + 1, wp - kw + 1
    if dtype == torch.float32:
        return ConvPlan(cin, cout, 64, 16)
    cin, cout = _up(cin, CHANNEL_ALIGN), _up(cout, CHANNEL_ALIGN)
    tw = min(TILE_WIDTHS, key=lambda t: _up(wo, t) * _up(ho, 128 // t))
    tiles = n * _cdiv(wo, tw) * _cdiv(ho, 128 // tw)
    return ConvPlan(cin, cout, wgmma_bn(tiles, cout, sms), tw)


def wgmma_bn(tiles: int, n: int, sms: int = SMS) -> int:
    """The BN of 128-row x BN wgmma tiles (`csrc/tma_gemm.cuh`) over `tiles`
    row tiles and n output columns whose waves x block cost is least: a
    block's time grows as BN + 64 (the A tile's loads stay whatever BN is),
    and padded columns count as work (the larger BN on a tie)."""
    return min(BN_CHOICES[::-1], key=lambda b: _cdiv(tiles * _cdiv(n, b), sms) * (b + 64))


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
    any kh and kw. A launch adds one to `conv2d_valid.launches`."""
    if x.device.type == "cpu":
        return conv2d_valid_plain(x, kernel)
    n, hp, wp, cin = x.shape
    kh, kw, kcin, cout = kernel.shape
    if kcin != cin or hp < kh or wp < kw:
        raise ValueError(f"conv2d_valid: x {tuple(x.shape)} and kernel {tuple(kernel.shape)} do not fit")
    if kernel.dtype != x.dtype or kernel.device != x.device:
        raise TypeError("conv2d_valid: kernel must match x's dtype and device")
    plan = conv_plan(x.dtype, n, hp, wp, cin, kh, kw, cout, _sms(x.device))
    x = _aligned(_pad_last(x, plan.cin))
    kernel = _aligned(_pad_last2(kernel, plan.cin, plan.cout))
    out = torch.empty((n, hp - kh + 1, wp - kw + 1, plan.cout), dtype=x.dtype, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("credit_conv_valid", [p, p, p] + [i] * 10 + [p])
    err = fn(x.data_ptr(), kernel.data_ptr(), out.data_ptr(), _build.dtype_code(x.dtype),
             n, hp, wp, plan.cin, kh, kw, plan.cout, plan.bn, plan.tw, _build.stream_ptr())
    _build.check(err, "credit_conv_valid")
    conv2d_valid.launches += 1
    return out if plan.cout == cout else out[..., :cout].contiguous()


conv2d_valid.launches = 0


# ------------------------------------------------------------ weight gradient
@dataclass(frozen=True)
class WgradPlan:
    """What one launch of kernel 5 is told: the channels it sees (bf16:
    padded to multiples of 8), BN output channels a block, K steps `sw`
    pixels wide (bf16: 64 // sw rows of them; f32: one row segment of 32),
    the taps a block owns (`group`, rows x columns: one in bf16; in f32 a
    2x2 group for kernels up to 2x2, a row of 3 for 3-wide kernels, else
    rows of 4), `splits` blocks sharing each tile's pixels, and the bytes of
    split partials the caller provides. The kernel's entry derives its grid
    and each split's share from these."""

    cin: int
    cout: int
    bn: int
    sw: int
    group: tuple
    splits: int
    workspace: int


@functools.lru_cache(maxsize=1024)
def wgrad_plan(dtype: torch.dtype, n: int, hp: int, wp: int, cin: int, kh: int, kw: int,
               cout: int, sms: int = SMS) -> WgradPlan:
    """bf16: K steps as wide as waste the fewest pixels at the right and
    bottom edges (the widest on a tie), the BN that pads Cout least (the
    larger on a tie), and the split count whose waves x K steps per block,
    at SM_FLOPS a block, plus the partials' traffic (each written, read,
    and the sum written) take least time (the fewest splits on a tie), with
    at least 8 K steps a split. f32: 64 x 64 tiles of a tap group, one row
    segment of 32 pixels a K step, splits for about 4 waves of two blocks
    per SM, at least 8 K steps a split."""
    ho, wo = hp - kh + 1, wp - kw + 1
    if dtype == torch.float32:
        tr, tc = (2, 2) if kh <= 2 and kw <= 2 else (1, 3) if kw == 3 else (1, 4)
        chunks = n * ho * _cdiv(wo, 32)
        tiles = _cdiv(cin, 64) * _cdiv(cout, 64) * _cdiv(kw, tc) * _cdiv(kh, tr)
        splits = max(1, min(_cdiv(4 * 2 * sms, tiles), chunks // 8))
        return WgradPlan(cin, cout, 64, 32, (tr, tc), splits,
                         splits * kh * kw * cin * cout * 4 if splits > 1 else 0)
    cin, cout = _up(cin, CHANNEL_ALIGN), _up(cout, CHANNEL_ALIGN)
    sw = min(SEG_WIDTHS, key=lambda s: _up(wo, s) * _up(ho, 64 // s))
    chunks = n * _cdiv(wo, sw) * _cdiv(ho, 64 // sw)
    bn = min(BN_CHOICES[::-1], key=lambda b: _up(cout, b))
    tiles = kh * kw * _cdiv(cin, 128) * _cdiv(cout, bn)
    step_s = 2.0 * 128 * bn * 64 / SM_FLOPS
    gk_bytes = kh * kw * cin * cout * 4

    def seconds(s: int) -> float:
        return (_cdiv(tiles * s, sms) * _cdiv(chunks, s) * step_s
                + (s > 1) * (2 * s + 1) * gk_bytes / HBM_BYTES_PER_S)

    splits = min(range(1, max(1, chunks // 8) + 1), key=seconds)
    splits = _cdiv(chunks, _cdiv(chunks, splits))  # no split left empty
    return WgradPlan(cin, cout, bn, sw, (1, 1), splits, splits * gk_bytes if splits > 1 else 0)


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
    Wp-kw+1, Cout) -> f32 (kh, kw, Cin, Cout); gy is rounded to x's dtype.
    A launch adds one to `conv2d_wgrad.launches`."""
    if x.device.type == "cpu":
        return conv2d_wgrad_plain(x, gy, kh, kw)
    n, hp, wp, cin = x.shape
    cout = gy.shape[-1]
    if gy.shape != (n, hp - kh + 1, wp - kw + 1, cout) or kh < 1 or kw < 1:
        raise ValueError(f"conv2d_wgrad: x {tuple(x.shape)}, gy {tuple(gy.shape)} and a "
                         f"{kh}x{kw} kernel do not fit")
    code = _build.dtype_code(x.dtype)
    plan = wgrad_plan(x.dtype, n, hp, wp, cin, kh, kw, cout, _sms(x.device))
    x = _aligned(_pad_last(x, plan.cin))
    gy = _aligned(_pad_last(gy.to(x.dtype), plan.cout))
    # per-split partial sums, added in a fixed order by the entry's second pass
    work = torch.empty(plan.workspace, dtype=torch.uint8, device=x.device)
    gk = torch.empty((kh, kw, plan.cin, plan.cout), dtype=torch.float32, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("credit_conv_wgrad", [p] * 4 + [i] * 13 + [p])
    err = fn(x.data_ptr(), gy.data_ptr(), gk.data_ptr(), work.data_ptr(), code, n, hp, wp,
             plan.cin, kh, kw, plan.cout, plan.bn, plan.sw, *plan.group, plan.splits,
             _build.stream_ptr())
    _build.check(err, "credit_conv_wgrad")
    conv2d_wgrad.launches += 1
    if (plan.cin, plan.cout) != (cin, cout):
        gk = gk[:, :, :cin, :cout].contiguous()
    return gk


conv2d_wgrad.launches = 0


class _ConvValid(torch.autograd.Function):
    """Forward: kernel 2. Backward as credit_tpu's `_bwd`: gx is kernel 2
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
    """Differentiable `conv2d_valid` (kernel 2 forward and input gradient,
    kernel 5 weight gradient); the input gradient is skipped when x needs
    none."""
    return _ConvValid.apply(x, kernel)

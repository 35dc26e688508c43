"""The TPU probes of `tools/` as kernels of the port's benches: two row-band
drafts of the stride-1 VALID conv (kernels 6a and 6b) and an identity copy
(kernel 7).

- `conv_band_dma` ports `tools/bench_pallas_conv.py` `make_pallas_conv`:
  the band of TH output rows with its halo arrives by bulk copies that
  complete on an mbarrier (`csrc/conv_band.cu` `credit_conv_band_dma`).
- `conv_band_halo` ports `make_blocked_pallas_conv`: the main rows and the
  halo rows through two pointers, one f32 partial per column tap
  (`credit_conv_band_halo`).
- `copy` ports `tools/bench_conv_ffk.py` `pallas_identity`
  (`csrc/copy.cu` `credit_copy`).

All three launch their CUDA kernels for CUDA tensors and run their plain
versions for CPU tensors. The convs compute kernel 2's function
(`cuda_conv.conv2d_valid`); their plain versions keep each draft's order of
summation. Only `credit_torch.tools` calls them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from credit_torch import _build

MAX_TH = 32  # output rows a band may have (8 warps x 4 rows)


def conv_band_dma_plain(x: torch.Tensor, kernel: torch.Tensor, th: int = 24) -> torch.Tensor:
    """The manual-DMA draft's sums in plain PyTorch: every tap (di, dj),
    row-major, adds its f32 product over the full input width, the rows
    shifted left by dj with wrap-around; the columns past Wo are cropped.
    Cutting the rows into bands of `th` changes no sum, so it is not done."""
    _check_th(th)
    n, hp, wp, cin = x.shape
    kh, kw, _, cout = kernel.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    xf, kf = x.float(), kernel.float()
    acc = torch.zeros((n, ho, wp, cout), dtype=torch.float32, device=x.device)
    for di in range(kh):
        rows = xf[:, di:di + ho]
        for dj in range(kw):
            sl = torch.roll(rows, -dj, dims=2) if dj else rows
            acc += sl @ kf[di, dj]
    return acc[:, :, :wo].to(x.dtype)


def conv_band_halo_plain(x: torch.Tensor, kernel: torch.Tensor, th: int = 24) -> torch.Tensor:
    """The two-ref draft's sums in plain PyTorch: the width zero-padded to a
    multiple of 16; for each column tap dj an f32 partial of its kh row taps,
    rolled left by dj and added; the columns past Wo are cropped."""
    _check_th(th)
    n, hp, wp, cin = x.shape
    kh, kw, _, cout = kernel.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    wpp = -(-wp // 16) * 16
    xf = F.pad(x.float(), (0, 0, 0, wpp - wp))
    kf = kernel.float()
    acc = torch.zeros((n, ho, wpp, cout), dtype=torch.float32, device=x.device)
    for dj in range(kw):
        pd = torch.zeros_like(acc)
        for di in range(kh):
            pd += xf[:, di:di + ho] @ kf[di, dj]
        acc += torch.roll(pd, -dj, dims=2) if dj else pd
    return acc[:, :, :wo].to(x.dtype)


def _check_th(th: int) -> None:
    if not 1 <= th <= MAX_TH:
        raise ValueError(f"conv_band: a band has 1 to {MAX_TH} output rows, got th={th}")


def _conv_band(entry: str, halo: bool, x: torch.Tensor, kernel: torch.Tensor, th: int):
    _check_th(th)
    n, hp, wp, cin = x.shape
    kh, kw, kcin, cout = kernel.shape
    if kcin != cin or hp < kh or wp < kw:
        raise ValueError(f"{entry}: x {tuple(x.shape)} and kernel {tuple(kernel.shape)} do not fit")
    if kernel.dtype != x.dtype or kernel.device != x.device:
        raise TypeError(f"{entry}: kernel must match x's dtype and device")
    if cin % 8 or cout % 8:
        raise ValueError(f"{entry}: the CUDA kernel takes Cin % 8 == 0 and Cout % 8 == 0, got "
                         f"{cin} -> {cout}")
    code = _build.dtype_code(x.dtype)
    # contiguous and 16-byte aligned: every pixel's channels are one bulk copy
    x, kernel = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x.contiguous(), kernel.contiguous()))
    out = torch.empty((n, hp - kh + 1, wp - kw + 1, cout), dtype=x.dtype, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    xs = [x.data_ptr(), x.data_ptr()] if halo else [x.data_ptr()]
    fn = _build.function(entry, [p] * (len(xs) + 2) + [i] * 9 + [p])
    err = fn(*xs, kernel.data_ptr(), out.data_ptr(), code, n, hp, wp, cin, kh, kw, cout, th,
             _build.stream_ptr())
    _build.check(err, entry)
    return out


def conv_band_dma(x: torch.Tensor, kernel: torch.Tensor, th: int = 24) -> torch.Tensor:
    """x (N, Hp, Wp, Cin), kernel (kh, kw, Cin, Cout) -> (N, Hp-kh+1,
    Wp-kw+1, Cout), in bands of `th` output rows staged by bulk copies."""
    if x.device.type == "cpu":
        return conv_band_dma_plain(x, kernel, th)
    out = _conv_band("credit_conv_band_dma", False, x, kernel, th)
    conv_band_dma.launches += 1
    return out


conv_band_dma.launches = 0


def conv_band_halo(x: torch.Tensor, kernel: torch.Tensor, th: int = 24) -> torch.Tensor:
    """The same function with the band's halo through a second pointer and
    per-column-tap partials."""
    if x.device.type == "cpu":
        return conv_band_halo_plain(x, kernel, th)
    out = _conv_band("credit_conv_band_halo", True, x, kernel, th)
    conv_band_halo.launches += 1
    return out


conv_band_halo.launches = 0


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def copy(x: torch.Tensor) -> torch.Tensor:
    """An identity copy of x into a new contiguous tensor."""
    if x.device.type == "cpu":
        return copy_plain(x)
    x = x.contiguous()
    nbytes = x.numel() * x.element_size()
    if nbytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"copy: the CUDA kernel copies 16-byte vectors, got {nbytes} bytes at "
                         f"offset {x.data_ptr() % 16}")
    out = torch.empty_like(x)
    p = ctypes.c_void_p
    fn = _build.function("credit_copy", [p, p, ctypes.c_longlong, p])
    _build.check(fn(x.data_ptr(), out.data_ptr(), nbytes, _build.stream_ptr()), "credit_copy")
    copy.launches += 1
    return out


copy.launches = 0

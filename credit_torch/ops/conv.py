"""2-D convolution primitives, channels-last (NHWC / HWIO): port of
credit_tpu/ops/conv.py with torch's output-size semantics.

Routing: every stride-1 VALID conv with kh*kw > 1 runs kernel 1 through
its autograd Function (`cuda_conv.conv2d_valid_diff`: kernel 1 forward and
input gradient, kernel 5 weight gradient); 1x1 convs are a `torch.matmul`
under autograd. Every stride-2 conv is rewritten as space-to-depth plus a
stride-1 half-kernel conv (an odd kernel is zero-extended to the next even
size first: FuXi's 3x3/s2 DownBlock conv becomes a 2x2 conv over 4 Cin
channels that wastes 7 of its 16 taps, where the TPU took a strided im2col),
and the stride-2 transposes with k = 2p + 2 as a phase conv plus
depth-to-space, so all land on the same two routes. `conv3d` takes the
non-overlapping patch form (a GEMM, as in credit_tpu). Other strides and
conv3d forms are not on the port's path yet and raise.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from credit_torch.ops import cuda_conv


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _pad_hw(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    if top or bottom or left or right:
        return F.pad(x, (0, 0, left, right, top, bottom))
    return x


def valid_conv(x: torch.Tensor, kernel: torch.Tensor, bias=None) -> torch.Tensor:
    """Stride-1 VALID conv: 1x1 as a GEMM, anything larger through kernel 1
    (differentiable). The bias is added in the output dtype."""
    kh, kw, cin, cout = kernel.shape
    kernel = kernel.to(x.dtype)
    if kh == 1 and kw == 1:
        n, h, w, _ = x.shape
        out = (x.reshape(-1, cin) @ kernel.reshape(cin, cout)).reshape(n, h, w, cout)
    else:
        out = cuda_conv.conv2d_valid_diff(x, kernel)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def conv2d(x: torch.Tensor, kernel: torch.Tensor, bias=None, stride=1,
           padding: Union[int, Sequence[int]] = 0) -> torch.Tensor:
    """Conv with torch-style symmetric integer padding.
    x: (N, H, W, Cin); kernel: (kh, kw, Cin, Cout)."""
    s = _pair(stride)
    ph, pw = _pair(padding)
    kh, kw = kernel.shape[0], kernel.shape[1]
    if s == (2, 2):
        return _conv2d_s2d(x, kernel, bias, (ph, pw))
    if s == (1, 1):
        return valid_conv(_pad_hw(x, ph, ph, pw, pw), kernel, bias)
    raise NotImplementedError(
        f"conv2d stride {s} with a {kh}x{kw} kernel is not ported yet "
        "(ROADMAP queue 1, item 2: ops/conv.py)")


def _conv2d_s2d(x, kernel, bias, pad: Tuple[int, int]):
    """Stride-2 conv as space-to-depth + stride-1 VALID conv:
    out[y,x] = sum_{a,b,r,s} phase_rs[y+a, x+b] K[2a+r, 2b+s]. An odd kernel
    gets a zero last row/column first (the output size stays the odd
    kernel's); odd padded dims get one extra zero row/col, and the outputs it
    touches are cut off."""
    n, h, w, cin = x.shape
    kh, kw, _, cout = kernel.shape
    ph, pw = pad
    ho = (h + 2 * ph - kh) // 2 + 1
    wo = (w + 2 * pw - kw) // 2 + 1
    if kh % 2 or kw % 2:
        kernel = F.pad(kernel, (0, 0, 0, 0, 0, kw % 2, 0, kh % 2))
        kh, kw = kernel.shape[0], kernel.shape[1]
    eh = (h + 2 * ph) % 2
    ew = (w + 2 * pw) % 2
    xp = _pad_hw(x, ph, ph + eh, pw, pw + ew)
    h2, w2 = (h + 2 * ph + eh) // 2, (w + 2 * pw + ew) // 2
    p = xp.reshape(n, h2, 2, w2, 2, cin).permute(0, 1, 3, 2, 4, 5).reshape(n, h2, w2, 4 * cin)
    # K'[a, b, (r*2+s)*cin + c, o] = K[2a+r, 2b+s, c, o]
    k2 = kernel.reshape(kh // 2, 2, kw // 2, 2, cin, cout).permute(0, 2, 1, 3, 4, 5)
    k2 = k2.reshape(kh // 2, kw // 2, 4 * cin, cout)
    out = valid_conv(p, k2)
    if out.shape[1] != ho or out.shape[2] != wo:
        out = out[:, :ho, :wo]
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def conv_transpose2d(x: torch.Tensor, kernel: torch.Tensor, bias=None, stride=2,
                     padding: Union[int, Sequence[int]] = 0) -> torch.Tensor:
    """Transposed conv with torch ConvTranspose2d semantics,
    out = (H - 1) * stride - 2 * padding + k. kernel: (kh, kw, Cin, Cout).
    Stride-2 transposes whose output is exactly 2H x 2W (k = 2p + 2: the
    decoder's k2/p0 and k4/p1) run as one phase conv + depth-to-space."""
    s = _pair(stride)
    ph, pw = _pair(padding)
    kh, kw = kernel.shape[0], kernel.shape[1]
    if s == (2, 2) and kh == 2 * ph + 2 and kw == 2 * pw + 2:
        return _conv_transpose2d_d2s(x, kernel, bias, (ph, pw))
    raise NotImplementedError(
        f"conv_transpose2d stride {s}, kernel {kh}x{kw}, padding {(ph, pw)} is "
        "not ported yet (ROADMAP queue 1, item 2: ops/conv.py)")


def _phase_taps(k: int, p: int):
    """Per-output-phase (d, u) taps of a stride-2 transposed conv:
    out[2a + r] = sum x[a + d] * W[u]."""
    taps = []
    for r in (0, 1):
        lst = []
        for t in range(k):
            num = r + t - (k - 1 - p)
            if num % 2 == 0:
                lst.append((num // 2, k - 1 - t))
        taps.append(lst)
    return taps


def phase_kernel(kernel: torch.Tensor, pad: Tuple[int, int]):
    """The phase-stacked kernel (window_h, window_w, cin, 4*cout) of a
    stride-2 transpose, and the window's (dh0, dh1, dw0, dw1) offsets."""
    kh, kw, cin, cout = kernel.shape
    taps_h = _phase_taps(kh, pad[0])
    taps_w = _phase_taps(kw, pad[1])
    dh = [d for lst in taps_h for d, _ in lst]
    dw = [d for lst in taps_w for d, _ in lst]
    dh0, dh1, dw0, dw1 = min(dh), max(dh), min(dw), max(dw)
    zero = kernel.new_zeros((cin, cout))
    rows = []
    for i in range(dh1 - dh0 + 1):
        cols = []
        for j in range(dw1 - dw0 + 1):
            blocks = []
            for r in (0, 1):
                th = dict(taps_h[r])
                for sph in (0, 1):
                    tw = dict(taps_w[sph])
                    uh, uw = th.get(i + dh0), tw.get(j + dw0)
                    blocks.append(kernel[uh, uw] if uh is not None and uw is not None else zero)
            cols.append(torch.cat(blocks, dim=-1))
        rows.append(torch.stack(cols, dim=0))
    return torch.stack(rows, dim=0), (dh0, dh1, dw0, dw1)


def _conv_transpose2d_d2s(x, kernel, bias, pad: Tuple[int, int]):
    n, h, w, _ = x.shape
    cout = kernel.shape[-1]
    k2, (dh0, dh1, dw0, dw1) = phase_kernel(kernel, pad)
    xp = _pad_hw(x, -dh0, dh1, -dw0, dw1)
    y = valid_conv(xp, k2)
    # depth-to-space: (N, H, W, 2, 2, C) -> (N, 2H, 2W, C)
    y = y.reshape(n, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, cout)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv3d(x: torch.Tensor, kernel: torch.Tensor, bias=None, stride=(1, 1, 1),
           padding=0) -> torch.Tensor:
    """3-D conv, channels-last: x (N, D, H, W, Cin), kernel (kd, kh, kw, Cin,
    Cout). Only the non-overlapping patch form (stride = kernel size, no
    padding: the CubeEmbedding) is ported: one GEMM of the patches against
    the flattened kernel in x's dtype, as credit_tpu's patch_conv3d_gemm;
    torch's Conv3d truncates dims that the patch does not divide, and so
    does this."""
    if isinstance(stride, int):
        stride = (stride,) * 3
    kd, kh, kw, cin, cout = kernel.shape
    if tuple(stride) != (kd, kh, kw) or padding not in (0, ((0, 0),) * 3):
        raise NotImplementedError(
            f"conv3d with stride {tuple(stride)}, kernel {(kd, kh, kw)} and padding {padding} "
            "is not ported yet (ROADMAP queue 1, item 2: ops/conv.py)")
    n, d, h, w, _ = x.shape
    do, ho, wo = d // kd, h // kh, w // kw
    p = x[:, :do * kd, :ho * kh, :wo * kw]
    p = p.reshape(n, do, kd, ho, kh, wo, kw, cin).permute(0, 1, 3, 5, 2, 4, 6, 7)
    out = p.reshape(-1, kd * kh * kw * cin) @ kernel.to(x.dtype).reshape(-1, cout)
    out = out.reshape(n, do, ho, wo, cout)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out

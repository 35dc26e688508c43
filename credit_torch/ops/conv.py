"""2-D convolution primitives, channels-last (NHWC / HWIO): port of
credit_tpu/ops/conv.py with torch's output-size semantics.

Routing: every stride-1 VALID conv with kh*kw > 1 runs kernel 2 through
its autograd Function (`cuda_conv.conv2d_valid_diff`: kernel 2 forward and
input gradient, kernel 5 weight gradient); 1x1 convs are a `torch.matmul`
under autograd. Every stride-2 conv is rewritten as space-to-depth plus a
stride-1 half-kernel conv (an odd kernel is zero-extended to the next even
size first: FuXi's 3x3/s2 DownBlock conv becomes a 2x2 conv over 4 Cin
channels that wastes 7 of its 16 taps, where the TPU took a strided im2col),
and the stride-2 transposes with k = 2p + 2 as a phase conv plus
depth-to-space, so all land on the same two routes. `conv3d`'s
non-overlapping patch form is a GEMM, as in credit_tpu. The forms no model
of the port reaches -- other strides, other transposes, other conv3d --
run PyTorch's own convolutions on the channels-last tensors, where
credit_tpu runs `lax.conv_general_dilated` (no Pallas kernel of the
reference computes them). Padding takes credit_tpu's forms: an int, a
(h, w) pair, or "VALID" / "SAME" / "SAME_LOWER" (lax's), and for conv3d an
int, three (low, high) pairs or one of those strings.
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
    """Stride-1 VALID conv: 1x1 as a GEMM, anything larger through kernel 2
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


def _same_pads(size: int, k: int, s: int, lower: bool) -> Tuple[int, int]:
    """lax's SAME (or SAME_LOWER) padding of one dim: the output is
    ceil(size / s), the total pad split with the odd element high (low)."""
    total = max(0, (-(-size // s) - 1) * s + k - size)
    return (total - total // 2, total // 2) if lower else (total // 2, total - total // 2)


def _pads(padding, spatial: Sequence[int], kernel: Sequence[int],
          stride: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """(low, high) per spatial dim of credit_tpu's padding argument."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return tuple((0, 0) for _ in spatial)
        if mode in ("SAME", "SAME_LOWER"):
            return tuple(_same_pads(n, k, s, mode == "SAME_LOWER")
                         for n, k, s in zip(spatial, kernel, stride))
        raise ValueError(f"padding {padding!r}: VALID, SAME or SAME_LOWER")
    if isinstance(padding, int):
        return tuple((padding, padding) for _ in spatial)
    pads = tuple(tuple(p) if isinstance(p, (tuple, list)) else (int(p), int(p)) for p in padding)
    if len(pads) != len(spatial):
        raise ValueError(f"padding {padding!r} for {len(spatial)} spatial dims")
    return pads


def _torch_conv(conv, x: torch.Tensor, weight: torch.Tensor, bias, **kw) -> torch.Tensor:
    """PyTorch's conv (F.conv2d, F.conv_transpose2d, F.conv3d) on a
    channels-last x, weight in PyTorch's layout, back to channels-last in
    x's dtype; the bias added in that dtype."""
    last = x.dim() - 1
    to_first = (0, last) + tuple(range(1, last))
    to_last = (0,) + tuple(range(2, last + 1)) + (1,)
    out = conv(x.permute(to_first), weight.to(x.dtype), **kw).permute(to_last).contiguous()
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def conv2d(x: torch.Tensor, kernel: torch.Tensor, bias=None, stride=1,
           padding: Union[int, Sequence[int], str] = 0) -> torch.Tensor:
    """Conv with torch-style symmetric integer padding, or credit_tpu's
    other padding forms (see the module). x: (N, H, W, Cin); kernel: (kh,
    kw, Cin, Cout). Strides 1 and 2 run kernel 2, any other stride
    PyTorch's conv."""
    s = _pair(stride)
    kh, kw = kernel.shape[0], kernel.shape[1]
    (top, bottom), (left, right) = _pads(padding, x.shape[1:3], (kh, kw), s)
    if s in ((1, 1), (2, 2)):
        if top != bottom or left != right:  # pad first, then a padding-free conv
            x, top, left = _pad_hw(x, top, bottom, left, right), 0, 0
        if s == (2, 2):
            return _conv2d_s2d(x, kernel, bias, (top, left))
        return valid_conv(_pad_hw(x, top, top, left, left), kernel, bias)
    return _torch_conv(F.conv2d, _pad_hw(x, top, bottom, left, right),
                       kernel.permute(3, 2, 0, 1), bias, stride=s)


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
    decoder's k2/p0 and k4/p1) run as one phase conv + depth-to-space on
    kernel 2, any other PyTorch's transposed conv."""
    s = _pair(stride)
    ph, pw = _pair(padding)
    kh, kw = kernel.shape[0], kernel.shape[1]
    if s == (2, 2) and kh == 2 * ph + 2 and kw == 2 * pw + 2:
        return _conv_transpose2d_d2s(x, kernel, bias, (ph, pw))
    return _torch_conv(F.conv_transpose2d, x, kernel.permute(2, 3, 0, 1), bias, stride=s,
                       padding=(ph, pw))


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
    Cout). The non-overlapping patch form (stride = kernel size, no
    padding: the CubeEmbedding) is one GEMM of the patches against the
    flattened kernel in x's dtype, as credit_tpu's patch_conv3d_gemm;
    torch's Conv3d truncates dims that the patch does not divide, and so
    does this. Any other stride and padding (an int, three (low, high)
    pairs, or lax's strings) runs PyTorch's conv3d."""
    if isinstance(stride, int):
        stride = (stride,) * 3
    kd, kh, kw, cin, cout = kernel.shape
    pads = _pads(padding, x.shape[1:4], (kd, kh, kw), stride)
    if tuple(stride) != (kd, kh, kw) or any(p != (0, 0) for p in pads):
        (d0, d1), (h0, h1), (w0, w1) = pads
        xp = F.pad(x, (0, 0, w0, w1, h0, h1, d0, d1)) if any(map(any, pads)) else x
        return _torch_conv(F.conv3d, xp, kernel.permute(4, 3, 0, 1, 2), bias,
                           stride=tuple(stride))
    n, d, h, w, _ = x.shape
    do, ho, wo = d // kd, h // kh, w // kw
    p = x[:, :do * kd, :ho * kh, :wo * kw]
    p = p.reshape(n, do, kd, ho, kh, wo, kw, cin).permute(0, 1, 3, 5, 2, 4, 6, 7)
    out = p.reshape(-1, kd * kh * kw * cin) @ kernel.to(x.dtype).reshape(-1, cout)
    out = out.reshape(n, do, ho, wo, cout)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out

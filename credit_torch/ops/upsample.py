"""Upsampling ops (port of credit_tpu/ops/upsample.py): pixel shuffle, the
ICNR kernel of a sub-pixel conv, and bilinear resize, channels-last."""

from __future__ import annotations

import math

import torch


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC pixel shuffle with torch's NCHW channel ordering:
    out[b, h*r+i, w*r+j, c] = in[b, h, w, c*r*r + i*r + j]."""
    n, h, w, crr = x.shape
    r = scale
    c = crr // (r * r)
    x = x.reshape(n, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c)


def truncated_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal draws of standard deviation `std` cut at two of it and
    rescaled to keep the variance (flax's truncated-normal variance
    scaling), on the generator's device."""
    t = torch.empty(shape, device=generator.device)
    s = std / 0.87962566103423978
    return torch.nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)


def icnr_kernel(shape, scale: int, generator: torch.Generator) -> torch.Tensor:
    """ICNR initialisation of a sub-pixel conv feeding `pixel_shuffle`
    (credit_tpu's icnr_kernel_init): a he_normal kernel (kh, kw, cin, cout)
    with each output channel repeated scale^2 times in a row, so all the
    sub-pixels of a channel start equal. `shape` is (kh, kw, cin,
    cout * scale^2)."""
    kh, kw, cin, cout_rr = shape
    sub = truncated_normal((kh, kw, cin, cout_rr // (scale * scale)),
                           math.sqrt(2.0 / (kh * kw * cin)), generator)
    return sub.repeat_interleave(scale * scale, dim=-1)


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(out, in) bilinear weights with half-pixel centres, antialiased when
    shrinking -- the triangle-kernel form of jax.image.resize."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    pos = torch.arange(in_size, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - (sample[:, None] - pos[None, :]).abs() / kscale, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of the two spatial axes of NHWC input; identity when
    the size already matches."""
    n, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    xf = x.float()
    wh = _resize_weights(h, out_h, x.device)
    ww = _resize_weights(w, out_w, x.device)
    y = torch.einsum("oh,nhwc->nowc", wh, xf)
    y = torch.einsum("pw,nowc->nopc", ww, y)
    return y.to(x.dtype)

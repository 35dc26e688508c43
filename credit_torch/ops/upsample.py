"""Upsampling ops (port of credit_tpu/ops/upsample.py): pixel shuffle, the
ICNR kernel of a sub-pixel conv, and bilinear resize, channels-last.

Where the ops see latitude slabs (`parallel.context.lat_slabs`), a resize
that changes the row count gives this rank's rows of the resized field
from its slab and a halo of its neighbours' rows, as deep as the row
weights' band reaches past any rank's slab; where that is deeper than a
slab, the gather path (`context.on_full`, site "resize").
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from credit_torch.parallel import context as par_ctx


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


@functools.lru_cache(maxsize=None)
def slab_halo(rows: int, out_rows: int, n: int) -> int:
    """The halo rows a slab resize of `rows` slab rows to `out_rows` output
    rows a rank needs over n ranks: how far the nonzero row weights of any
    rank's output rows reach past its slab."""
    wh = _resize_weights(rows * n, out_rows * n, "cpu") != 0
    need = 0
    for r in range(n):
        cols = wh[r * out_rows:(r + 1) * out_rows].any(dim=0).nonzero()
        if len(cols):
            need = max(need, r * rows - int(cols[0]), int(cols[-1]) - ((r + 1) * rows - 1))
    return need


def _slab_rows(x: torch.Tensor, out_h: int, dom) -> torch.Tensor:
    """This rank's out_h rows of the latitude resize of the field whose
    slab x is, in f32 (x's slab and its halo rows, exchanged in x's dtype)."""
    from credit_torch.parallel.halo import halo_exchange

    group, n, r = dom
    h = x.shape[1]
    halo = slab_halo(h, out_h, n)
    whp = F.pad(_resize_weights(h * n, out_h * n, x.device), (halo, halo))
    wh = whp[r * out_h:(r + 1) * out_h, r * h:(r + 1) * h + 2 * halo]
    return torch.einsum("oh,nhwc->nowc", wh, halo_exchange(x, halo, group).float())


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of the two spatial axes of NHWC input; identity when
    the size already matches. On latitude slabs `out_h` is this rank's rows
    of the output (n * out_h in all, split evenly); see the module."""
    n, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    dom = par_ctx.domain_group() if h != out_h else None
    if dom is not None:
        if len(set(par_ctx.slab_rows(h))) > 1 or slab_halo(h, out_h, dom[1]) > h:
            return par_ctx.on_full(lambda t: bilinear_resize(t, out_h * dom[1], out_w), x, dom,
                                   "resize")
        y = _slab_rows(x, out_h, dom)
        ww = _resize_weights(w, out_w, x.device)
        return torch.einsum("pw,nowc->nopc", ww, y).to(x.dtype)
    xf = x.float()
    wh = _resize_weights(h, out_h, x.device)
    ww = _resize_weights(w, out_w, x.device)
    y = torch.einsum("oh,nhwc->nowc", wh, xf)
    y = torch.einsum("pw,nowc->nopc", ww, y)
    return y.to(x.dtype)

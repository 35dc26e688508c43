"""Windowed (short) and dilated-grid (long) attention for lat-lon feature
maps: port of credit_tpu/ops/window_attention.py.

Window semantics:
  short: non-overlapping w x w spatial windows  -- "b (h s1) (w s2) c"
  long:  dilated grid, stride (H/w, W/w)        -- "b (l1 h) (l2 w) c"
"""

from __future__ import annotations

import numpy as np
import torch


def window_partition(x: torch.Tensor, wsz: int, kind: str) -> torch.Tensor:
    """(B, H, W, C) -> (B, nWin, w*w, C)."""
    b, h, w, c = x.shape
    if h % wsz or w % wsz:
        raise ValueError(
            f"window size {wsz} must divide the padded feature map ({h}x{w}) "
            f"at every stage -- adjust model.local/global_window_size or "
            f"padding_conf so each stage's H and W are multiples")
    nh, nw = h // wsz, w // wsz
    if kind == "short":
        x = x.reshape(b, nh, wsz, nw, wsz, c).permute(0, 1, 3, 2, 4, 5)
    elif kind == "long":
        x = x.reshape(b, wsz, nh, wsz, nw, c).permute(0, 2, 4, 1, 3, 5)
    else:
        raise ValueError(kind)
    return x.reshape(b, nh * nw, wsz * wsz, c)


def window_unpartition(x: torch.Tensor, wsz: int, h: int, w: int, kind: str) -> torch.Tensor:
    """Inverse of window_partition: (B, nWin, w*w, C) -> (B, H, W, C)."""
    b, nwin, toks, c = x.shape
    nh, nw = h // wsz, w // wsz
    x = x.reshape(b, nh, nw, wsz, wsz, c)
    if kind == "short":
        x = x.permute(0, 1, 3, 2, 4, 5)
    elif kind == "long":
        x = x.permute(0, 3, 1, 4, 2, 5)
    else:
        raise ValueError(kind)
    return x.reshape(b, h, w, c)


def relative_position_index(wsz: int, device=None) -> torch.Tensor:
    """(w*w, w*w) int64 indices into the relative-position bias table, with
    the reference's stride 2w-1, made with arange on `device`."""
    pos = torch.arange(wsz, device=device)
    grid = torch.stack(torch.meshgrid(pos, pos, indexing="ij")).reshape(2, -1).T
    rel = grid[:, None] - grid[None, :] + (wsz - 1)
    return rel[..., 0] * (2 * wsz - 1) + rel[..., 1]


def relative_position_grid(wsz: int) -> np.ndarray:
    """((2w+1)^2, 2) float offsets in [-w, w] fed to DynamicPositionBias.
    The reference builds this (2w+1)^2 table but indexes it with stride
    2w-1 (relative_position_index); both are kept as they are."""
    pos = np.arange(-wsz, wsz + 1, dtype=np.float32)
    g = np.stack(np.meshgrid(pos, pos, indexing="ij"))
    return g.reshape(2, -1).T


_VPU_MAX_T = 32  # the reference's tiny-T path bound (f32 scores below it)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The reference's plain attention: q, k, v (B, nWin, T, heads*dh),
    bias (T, T) -> (B, nWin, T, heads*dh). Like the reference, bf16 inputs
    with T > 32 keep the scores and softmax in bf16; otherwise scores are
    f32 and the probabilities are cast to v's dtype."""
    b, nwin, t, inner = q.shape
    dh = inner // num_heads
    scale = torch.tensor(dh ** -0.5, dtype=q.dtype)

    def split(z):  # (b, n, t, h, dh) -> (b, n, h, t, dh)
        return z.reshape(b, nwin, t, num_heads, dh).transpose(2, 3)

    qs, ks, vs = split(q * scale), split(k), split(v)
    if v.dtype == torch.bfloat16 and t > _VPU_MAX_T:
        sim = (qs.float() @ ks.float().transpose(-1, -2)).to(torch.bfloat16)
        sim = sim + bias.to(torch.bfloat16)
        attn = torch.softmax(sim.float(), dim=-1).to(torch.bfloat16)
    else:
        sim = qs.float() @ ks.float().transpose(-1, -2) + bias.float()
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = (attn.float() @ vs.float()).to(v.dtype)
    return out.transpose(2, 3).reshape(b, nwin, t, inner)

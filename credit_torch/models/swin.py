"""Swin Transformer V2 blocks and the standalone model: port of
credit_tpu/models/swin.py.

Cosine attention with a learned per-head logit scale, the log-spaced
continuous relative-position bias (CPB MLP), shifted windows with a -100
mask, post-norm residuals. Channels-last; windows partition as reshapes.
The MLP half of every block is the fused post-norm FF (kernel 1 forward,
kernel 4 backward) whatever the reference's `mlp_fuse` gate says: that gate
is a TPU routing key. The attention has no Pallas kernel in credit_tpu and
runs here as plain PyTorch with the reference's numerics (f32 scores and
softmax, the weights cast to the compute dtype before the product with v).

The CPB table, the relative index and the shift masks are made with
`arange` on the activation's device at call time, never stored; inside
`layers.position_bias_cache(model)` each is computed once. Windows are the
CrossFormer's "short" windows (`ops.window_attention`).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from credit_torch import registry
from credit_torch.models.base import DTYPES, BaseModel, channels_to_frames, frames_to_channels
from credit_torch.models.layers import Dense, LayerNorm, _param
from credit_torch.ops import window_attention as wa
from credit_torch.ops.cuda_ff import fused_ff_diff


def relative_coords_table(ws: int, device=None) -> torch.Tensor:
    """Log-spaced normalised relative coordinates ((2 ws - 1)^2, 2), f32."""
    coords = torch.arange(-(ws - 1), ws, dtype=torch.float32, device=device)
    table = torch.stack(torch.meshgrid(coords, coords, indexing="ij"), dim=-1)
    table = table / (ws - 1) * 8.0
    table = torch.sign(table) * torch.log2(table.abs() + 1.0) / math.log2(8.0)
    return table.reshape(-1, 2)


def shift_attn_mask(h: int, w: int, ws: int, shift: int, device=None) -> torch.Tensor:
    """(nWin, T, T) additive f32 mask of the shifted windows: -100 between
    tokens of different regions, 0 within one."""

    def region(n):
        i = torch.arange(n, device=device)
        return torch.where(i < n - ws, 0, torch.where(i < n - shift, 1, 2))

    img = region(h)[:, None] * 3 + region(w)[None, :]
    win = img.reshape(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, :, None] != win[:, None, :]
    return torch.where(diff, -100.0, 0.0).to(torch.float32)


class WindowAttentionV2(nn.Module):
    """SwinV2 window attention on (nB, T, C) window tokens: one `qkv`
    kernel with q and v biases only, cosine scores in f32 times
    exp(min(logit_scale, log 100)), the CPB bias 16 sigmoid(MLP(table))
    per head, the shift mask per window, softmax in f32, then `proj`."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        f32 = torch.float32
        self.qkv = Dense(dim, 3 * dim, use_bias=False, dtype=dtype, spectral=False)
        self.q_bias = _param(dim)
        self.v_bias = _param(dim)
        self.logit_scale = _param(num_heads, 1, 1, fill=math.log(10.0))
        self.cpb_fc1 = Dense(2, 512, dtype=f32, spectral=False)
        self.cpb_fc2 = Dense(512, num_heads, use_bias=False, dtype=f32, spectral=False)
        self.proj = Dense(dim, dim, dtype=dtype, spectral=False)
        self.cache_bias = False
        self.clear_cache()

    def clear_cache(self):
        self.bias_cache, self.mask_cache = {}, {}

    def position_bias(self, ws: int, device) -> torch.Tensor:
        """(heads, T, T) f32 continuous position bias."""
        if self.cache_bias and ws in self.bias_cache:
            return self.bias_cache[ws]
        cpb = self.cpb_fc2(F.relu(self.cpb_fc1(relative_coords_table(ws, device))))
        bias = 16.0 * torch.sigmoid(cpb[wa.relative_position_index(ws, device)].permute(2, 0, 1))
        if self.cache_bias:
            self.bias_cache[ws] = bias
        return bias

    def shift_mask(self, h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
        key = (h, w, ws, shift)
        if self.cache_bias and key in self.mask_cache:
            return self.mask_cache[key]
        mask = shift_attn_mask(h, w, ws, shift, device)
        if self.cache_bias:
            self.mask_cache[key] = mask
        return mask

    def forward(self, xw: torch.Tensor, ws: int, mask=None) -> torch.Tensor:
        nb, t, c = xw.shape
        h, dt = self.num_heads, self.dtype
        # one GEMM against the whole kernel, then column slices: each
        # element is the reference's per-slice product
        q, k, v = (xw.to(dt) @ self.qkv.kernel.to(dt)).split(c, dim=-1)
        q = q + self.q_bias.to(dt)
        v = v + self.v_bias.to(dt)
        q, k, v = (z.reshape(nb, t, h, c // h).transpose(1, 2) for z in (q, k, v))
        qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
        kn = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
        attn = qn.float() @ kn.float().transpose(-2, -1)  # (nB, heads, T, T)
        attn = attn * torch.exp(torch.clamp(self.logit_scale.float(), max=math.log(100.0)))
        attn = attn + self.position_bias(ws, xw.device)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(nb // nw, nw, h, t, t) + mask[None, :, None]).reshape(nb, h, t, t)
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = (attn @ v.to(dt)).transpose(1, 2).reshape(nb, t, c)
        return self.proj(out)


class SwinBlockV2(nn.Module):
    """(shifted) window attention with the post-norm residual
    x + norm1(attn(x)), then the post-norm MLP x + norm2(fc2(GELU(fc1(x))))
    as one fused FF call."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int = 0,
                 mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.window_size, self.shift, self.dtype = window_size, shift, dtype
        hidden = int(dim * mlp_ratio)
        self.attn = WindowAttentionV2(dim, num_heads, dtype)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.mlp_fc1 = Dense(dim, hidden, dtype=dtype, spectral=False)
        self.mlp_fc2 = Dense(hidden, dim, dtype=dtype, spectral=False)
        self.norm2 = LayerNorm(dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        ws = min(self.window_size, h, w)
        shift = self.shift if ws < min(h, w) else 0
        y, mask = x, None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = self.attn.shift_mask(h, w, ws, shift, x.device)
        yw = wa.window_partition(y, ws, "short")
        b, nwin, t, c = yw.shape
        yw = self.attn(yw.reshape(b * nwin, t, c), ws, mask)
        y = wa.window_unpartition(yw.reshape(b, nwin, t, c), ws, h, w, "short")
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self.norm1(y)
        dt = self.dtype
        return fused_ff_diff(x.to(dt), self.norm2.scale, self.norm2.bias,
                             self.mlp_fc1.kernel.to(dt), self.mlp_fc1.bias,
                             self.mlp_fc2.kernel.to(dt), self.mlp_fc2.bias, post_norm=True)


class SwinStageV2(nn.Module):
    """depth SwinV2 blocks (`block{i}`), alternating plain and shifted
    windows, unrolled: credit_tpu's `scan_blocks` layout (`blocks/b0, b1`
    pairs) is unstacked by the bridge (models/scan_utils.py)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 dtype=torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", SwinBlockV2(
                dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return x


@registry.register("model", "swin")
class SwinTransformerV2(BaseModel):
    """Standalone SwinV2 forecast model: patch embed (a Dense on flattened
    patches) -> one same-resolution SwinV2 stage -> Dense patch recovery."""

    ROUTING_KEYS = ("remat",)

    def __init__(self, image_height: int = 181, image_width: int = 360, patch_height: int = 4,
                 patch_width: int = 4, frames: int = 1, output_frames: int = 1,
                 channels: int = 4, surface_channels: int = 4, input_only_channels: int = 0,
                 output_only_channels: int = 0, levels: int = 15, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 8, window_size: int = 7,
                 compute_dtype: Any = torch.float32, sn_state: bool = False, **routing):
        super().__init__()
        self._check_routing(routing)
        if isinstance(compute_dtype, str):
            compute_dtype = DTYPES[compute_dtype]
        self.patch = (patch_height, patch_width)
        self.window_size, self.output_frames = window_size, output_frames
        self.base_input_channels = channels * levels + surface_channels + input_only_channels
        self.base_output_channels = channels * levels + surface_channels + output_only_channels
        dt = compute_dtype
        cin = self.base_input_channels * frames * patch_height * patch_width
        cout = self.base_output_channels * output_frames * patch_height * patch_width
        self.embed = Dense(cin, embed_dim, dtype=dt, spectral=False)
        self.stage = SwinStageV2(embed_dim, depth, num_heads, window_size, dt)
        self.head = Dense(embed_dim, cout, dtype=dt, spectral=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hh, ww, _ = x.shape
        ph, pw = self.patch
        x = frames_to_channels(x)
        x = F.pad(x, (0, 0, 0, (-ww) % pw, 0, (-hh) % ph))
        h2, w2 = x.shape[1] // ph, x.shape[2] // pw
        x = x.reshape(b, h2, ph, w2, pw, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, h2, w2, -1)
        x = self.embed(x)
        ws = self.window_size
        x = F.pad(x, (0, 0, 0, (-w2) % ws, 0, (-h2) % ws))
        x = self.stage(x)[:, :h2, :w2]
        x = self.head(x)
        out_c = x.shape[-1] // (ph * pw)
        x = x.reshape(b, h2, w2, ph, pw, out_c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h2 * ph, w2 * pw, out_c)[:, :hh, :ww]
        return channels_to_frames(x, self.output_frames)

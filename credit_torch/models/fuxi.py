"""FuXi: cube embedding + U-Transformer (SwinV2 core) + patch recovery:
port of credit_tpu/models/fuxi.py, on folded kernels or with spectral-norm
state (`sn_state=True`, training).

Order: earth pad, the Conv3d patch embed with its LayerNorm (a GEMM),
DownBlock (3x3/s2 conv, two 3x3 residual convs with GroupNorm and SiLU), a
symmetric zero pad to a window multiple, the SwinV2 stage, the crop, the
skip concat, UpBlock (ConvTranspose 2x2/s2 and two residual convs), the
dense patch recovery, unpad, bilinear resize, channels to frames. Only the
Down/UpBlock convs carry spectral norm, as in the reference. Input
(B, T, H, W, C_in), output (B, 1, H, W, C_out).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from credit_torch import registry
from credit_torch.models.base import DTYPES, BaseModel, channels_to_frames
from credit_torch.models.layers import Conv, CubeEmbedding, Dense, GroupNorm, UpBlock
from credit_torch.models.swin import SwinStageV2
from credit_torch.ops.padding import TensorPadding
from credit_torch.ops.upsample import bilinear_resize


class DownBlock(nn.Module):
    """3x3/s2 conv, then residual (3x3 conv, GroupNorm, SiLU) x n plus the
    shortcut from the strided conv."""

    def __init__(self, dim: int, num_groups: int, num_residuals: int = 2,
                 dtype=torch.float32, sn: bool = False):
        super().__init__()
        self.num_residuals = num_residuals
        self.down = Conv(dim, dim, 3, 2, 1, dtype, sn)
        for i in range(num_residuals):
            self.add_module(f"res_conv{i}", Conv(dim, dim, 3, 1, 1, dtype, sn))
            self.add_module(f"res_gn{i}", GroupNorm(num_groups, dim, dtype=dtype))

    def forward(self, x):
        x = self.down(x)
        shortcut = x
        for i in range(self.num_residuals):
            x = F.silu(getattr(self, f"res_gn{i}")(getattr(self, f"res_conv{i}")(x)))
        return x + shortcut


class UTransformer(nn.Module):
    """DownBlock -> symmetric zero pad to a window multiple -> SwinV2 stage
    -> crop -> skip concat -> UpBlock."""

    def __init__(self, dim: int, num_groups: int, num_heads: int, window_size: int, depth: int,
                 dtype=torch.float32, sn: bool = False):
        super().__init__()
        self.window_size = window_size
        self.down = DownBlock(dim, num_groups, dtype=dtype, sn=sn)
        self.swin = SwinStageV2(dim, depth, num_heads, window_size, dtype)
        self.up = UpBlock(2 * dim, dim, num_groups, dtype=dtype, sn=sn)

    def forward(self, x):
        x = self.down(x)
        shortcut = x
        _, h, w, _ = x.shape
        ph, pw = (-h) % self.window_size, (-w) % self.window_size
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        x = self.swin(x)[:, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]
        return self.up(torch.cat([shortcut, x], dim=-1))


@registry.register("model", "fuxi")
class Fuxi(BaseModel):
    """Constructor arguments mirror the reference config's model keys.
    `use_spectral_norm` says whether the Down/UpBlock convs carry spectral
    norm: folded into their kernels with `sn_state=False` (inference), as
    u/v buffers beside them with `sn_state=True` (training)."""

    ROUTING_KEYS = ("pallas_conv", "ff_fusion", "scan_blocks", "remat")

    def __init__(self, image_height: int = 640, patch_height: int = 16, image_width: int = 1280,
                 patch_width: int = 16, levels: int = 15, frames: int = 2,
                 frame_patch_size: int = 2, dim: int = 1536, num_groups: int = 32,
                 channels: int = 4, surface_channels: int = 7, input_only_channels: int = 0,
                 output_only_channels: int = 0, num_heads: int = 8, depth: int = 48,
                 window_size: int = 7, use_spectral_norm: bool = True, interp: bool = True,
                 padding_conf: Any = None, compute_dtype: Any = torch.float32,
                 sn_state: bool = False, **routing):
        super().__init__()
        self._check_routing(routing)
        if isinstance(compute_dtype, str):
            compute_dtype = DTYPES[compute_dtype]
        self.image_height, self.image_width = image_height, image_width
        self.patch = (patch_height, patch_width)
        self.dim, self.interp = dim, interp
        self.use_spectral_norm = use_spectral_norm
        self.compute_dtype = dt = compute_dtype
        sn = bool(use_spectral_norm and sn_state)
        self.base_input_channels = channels * levels + surface_channels + input_only_channels
        self.base_output_channels = channels * levels + surface_channels + output_only_channels
        pconf = padding_conf or {"activate": False}
        self.padder = TensorPadding(**pconf) if pconf.get("activate") else None
        self.cube_embedding = CubeEmbedding(self.base_input_channels, dim,
                                            (frame_patch_size, patch_height, patch_width), dt)
        self.u_transformer = UTransformer(dim, num_groups, num_heads, window_size, depth, dt, sn)
        self.fc = Dense(dim, self.base_output_channels * patch_height * patch_width, dtype=dt,
                        spectral=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padder is not None:
            x = self.padder.pad(x)
        b = x.shape[0]
        x = self.cube_embedding(x)
        # (B, T', H', W', dim) with T' = frames // frame_patch_size == 1
        x = x.reshape(b, x.shape[2], x.shape[3], self.dim)
        x = self.fc(self.u_transformer(x))
        ph, pw = self.patch
        hh, ww, out_c = x.shape[1], x.shape[2], self.base_output_channels
        x = x.reshape(b, hh, ww, ph, pw, out_c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, hh * ph, ww * pw, out_c)
        if self.padder is not None:
            x = self.padder.unpad(x)
        if self.interp:
            x = bilinear_resize(x, self.image_height, self.image_width)
        return channels_to_frames(x, 1)

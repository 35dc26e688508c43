"""Plain U-Net: port of credit_tpu/models/unet.py (`unet`,
`unet_downscaling`).

Frames to channels, zero pad (bottom and right) to a multiple of
2^(n-1), n ConvBlocks (3x3 conv, GroupNorm(min(8, features)), SiLU,
twice) with a 2x2 max pool before each but the first, then per level up a
2x2/s2 transpose (its phase conv is a 1x1 GEMM), the skip concat and a
ConvBlock; a 1x1 head (a GEMM), the crop to the input grid, and a
bilinear resize where `image_height/width` differ from it. The 3x3 convs
run kernel 2.

Under a mesh with domain > 1 the forward is lat-sharded (`_forward_slabs`):
the zero pad runs on the whole field, each domain rank then keeps its
latitude slab of the padded rows. The 3x3 convs run on the slab extended
by the halo exchange, GroupNorm takes its moments over every rank's rows,
the 2x2 pools and transposes are local. A level whose slab rows are odd
before its pool is pooled and run on the whole field (gathered), and the
up path cuts it back to slabs at the first skip that is one. The head's
output is gathered; every rank crops and resizes the whole field.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from credit_torch import registry
from credit_torch.models.base import DTYPES, BaseModel, channels_to_frames, frames_to_channels
from credit_torch.models.layers import Conv, ConvTranspose, GroupNorm
from credit_torch.ops.upsample import bilinear_resize
from credit_torch.parallel import context as par_ctx


class ConvBlock(nn.Module):
    """(3x3 conv, GroupNorm, SiLU) x 2."""

    def __init__(self, in_ch: int, features: int, num_groups: int = 8, dtype=torch.float32,
                 sn: bool = False):
        super().__init__()
        for i in range(2):
            self.add_module(f"conv{i}", Conv(in_ch if i == 0 else features, features, 3, 1, 1,
                                             dtype, sn))
            self.add_module(f"gn{i}", GroupNorm(min(num_groups, features), features,
                                                dtype=dtype))

    def forward(self, x):
        for i in range(2):
            x = F.silu(getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x)))
        return x


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """flax's VALID 2x2/s2 max pool of NHWC input (an odd last row or
    column is dropped)."""
    n, h, w, c = x.shape
    x = x[:, :h - h % 2, :w - w % 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


@registry.register("model", "unet")
@registry.register("model", "unet_downscaling")
class UNet(BaseModel):
    """Constructor arguments mirror the reference config's model keys;
    `use_spectral_norm` puts spectral norm on the 3x3 convs and the
    transposes (never on the head)."""

    def __init__(self, image_height: int = 181, image_width: int = 360, frames: int = 1,
                 output_frames: int = 1, channels: int = 4, surface_channels: int = 4,
                 input_only_channels: int = 0, output_only_channels: int = 0, levels: int = 15,
                 encoder_dims: Sequence[int] = (64, 128, 256, 512),
                 use_spectral_norm: bool = False, compute_dtype: Any = torch.float32,
                 sn_state: bool = False):
        super().__init__()
        if isinstance(compute_dtype, str):
            compute_dtype = DTYPES[compute_dtype]
        self.image_height, self.image_width = image_height, image_width
        self.output_frames = output_frames
        self.use_spectral_norm = use_spectral_norm
        self.compute_dtype = dt = compute_dtype
        sn = bool(use_spectral_norm and sn_state)
        self.base_input_channels = channels * levels + surface_channels + input_only_channels
        self.base_output_channels = channels * levels + surface_channels + output_only_channels
        self.dims = dims = tuple(encoder_dims)
        c = self.stacked_input_channels() * frames
        for i, d in enumerate(dims):
            self.add_module(f"enc{i}", ConvBlock(c, d, dtype=dt, sn=sn))
            c = d
        for i in reversed(range(len(dims) - 1)):
            self.add_module(f"up{i}", ConvTranspose(c, dims[i], 2, 2, 0, dt, sn))
            self.add_module(f"dec{i}", ConvBlock(2 * dims[i], dims[i], dtype=dt, sn=sn))
            c = dims[i]
        self.head = Conv(c, self.base_output_channels * output_frames, 1, dtype=dt,
                         spectral=False)

    def stacked_input_channels(self) -> int:
        """Channels of one input frame as the encoder sees it."""
        return self.base_input_channels

    # the forward splits latitude over the domain ranks (_forward_slabs)
    lat_sharded = True

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        """Frames to channels, zero rows and columns at the bottom and
        right up to a multiple of 2^(levels - 1)."""
        hh, ww = x.shape[2], x.shape[3]
        mult = 2 ** (len(self.dims) - 1)
        return F.pad(frames_to_channels(x), (0, 0, 0, (-ww) % mult, 0, (-hh) % mult))

    def _out(self, x: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
        """The crop to the input grid, the resize to the model's."""
        x = x[:, :hh, :ww]
        if (hh, ww) != (self.image_height, self.image_width):
            x = bilinear_resize(x, self.image_height, self.image_width)
        return channels_to_frames(x, self.output_frames)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if par_ctx.halo_mesh_active():
            return self._forward_slabs(x)
        hh, ww = x.shape[2], x.shape[3]
        x = self._padded(x)
        skips = []
        for i in range(len(self.dims)):
            if i > 0:
                x = max_pool2(x)
            x = getattr(self, f"enc{i}")(x)
            skips.append(x)
        for i in reversed(range(len(self.dims) - 1)):
            x = getattr(self, f"up{i}")(x)
            x = getattr(self, f"dec{i}")(torch.cat([x, skips[i]], dim=-1))
        return self._out(self.head(x), hh, ww)

    def _forward_slabs(self, x: torch.Tensor) -> torch.Tensor:
        """forward with latitude split over the mesh's domain ranks (see
        the module); the same function of x on every domain rank."""
        from credit_torch.parallel.halo import gather_lat, scale_grad, shard_lat

        group, n, r = par_ctx.mesh_domain()
        hh, ww = x.shape[2], x.shape[3]
        x = self._padded(x)
        sh = x.shape[1] % n == 0
        if sh:
            x = shard_lat(x, n, r)

        def run(fn, t, on_slabs):
            with par_ctx.lat_slabs(on_slabs):
                return fn(t)

        skips = []
        for i in range(len(self.dims)):
            if i > 0:
                if sh and x.shape[1] % 2:  # this level's pools straddle two slabs
                    x, sh = par_ctx.gather_whole(x, group, "level"), False
                x = max_pool2(x)
            x = run(getattr(self, f"enc{i}"), x, sh)
            skips.append((x, sh))
        for i in reversed(range(len(self.dims) - 1)):
            x = run(getattr(self, f"up{i}"), x, sh)
            e, e_sh = skips[i]
            if e_sh and not sh:
                x, sh = shard_lat(x, n, r), True
            x = run(getattr(self, f"dec{i}"), torch.cat([x, e], dim=-1), sh)
        x = run(self.head, x, sh)
        # every domain rank computes the same from here on (as the CrossFormer's)
        x = gather_lat(x, group, same_downstream=True) if sh else scale_grad(x, 1.0 / n)
        return self._out(x, hh, ww)

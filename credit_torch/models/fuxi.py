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

Under a mesh with domain > 1 (`parallel.context.explicit_halo`) the
forward is lat-sharded: the earth padding runs on the whole field, then
each domain rank keeps its even slab of the padded rows. The cube embed
and its LayerNorm are row-local; the DownBlock's 3x3/s2 conv runs the
local space-to-depth on its halo-extended slab, its residual convs the
halo exchange, GroupNorm's moments are summed over the ranks. The stage's
symmetric window pad makes R window rows, which `UTransformer` re-splits
(`parallel.halo.reslab`, one all-gather) into window-aligned slabs of
ceil(R/n) / floor(R/n) window rows, the first and last rank holding the
pad; the SwinV2 blocks run on those (models/swin.py), and the crop goes
back to the even slabs for the skip concat and the UpBlock (its 2x2/s2
transpose on the d2s phase seam). The dense patch recovery runs on the
slabs, whose rows are then gathered (every rank computes the same unpad,
resize and loss, as the CrossFormer family does). `lat_split_problem`
says where the rows do not split that way; the trainer's validator raises
it. No gather path is taken inside the model.
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
from credit_torch.parallel import context as par_ctx
from credit_torch.parallel.halo import gather_lat, reslab, shard_lat, window_rows


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


def split_problem(name: str, rows: int, window: int, n: int):
    """Why a UTransformer fed `rows` rows (the cube embed's) does not run
    on n even latitude slabs, or None: each slab must hold an even number
    of rows (the stride-2 DownBlock conv), and the stage's padded rows at
    least one window row a rank."""
    if rows % (2 * n):
        return (f"model {name}: {rows} embedded rows do not split into {n} slabs of an even "
                f"number of rows (the 3x3/s2 DownBlock conv)")
    r = -(-(rows // 2) // window)
    if r < n:
        return f"model {name}: the SwinV2 stage's {r} window rows do not split over domain={n}"
    return None


class UTransformer(nn.Module):
    """DownBlock -> symmetric zero pad to a window multiple -> SwinV2 stage
    -> crop -> skip concat -> UpBlock. On latitude slabs (see the module)
    the stage runs on window-aligned slabs."""

    zero_container = True  # ZeRO-3 gathers the Down/UpBlock and each SwinV2 block apart

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
        dom = par_ctx.domain_group()
        if dom is not None:
            x = self._swin_slabs(x, dom)
        else:
            _, h, w, _ = x.shape
            ph, pw = (-h) % self.window_size, (-w) % self.window_size
            x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            x = self.swin(x)[:, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]
        return self.up(torch.cat([shortcut, x], dim=-1))

    def _swin_slabs(self, x, dom):
        """The stage on window-aligned slabs of the padded rows, from and
        back to the even slabs of x."""
        group, n, r = dom
        ws = self.window_size
        even = (x.shape[1],) * n
        h, w = x.shape[1] * n, x.shape[2]
        ph, pw = (-h) % ws, (-w) % ws
        top = ph // 2
        rows = window_rows(h + ph, ws, n)
        if not all(rows):
            raise ValueError(f"the SwinV2 stage's {(h + ph) // ws} window rows do not split "
                             f"over domain={n}")
        starts = [sum(rows[:i]) - top for i in range(n)]  # in the unpadded rows
        real = tuple(min(s0 + c, h) - max(s0, 0) for s0, c in zip(starts, rows))
        x = reslab(x, even, real, group)
        t0 = top if r == 0 else 0
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, t0, ph - top if r == n - 1 else 0))
        with par_ctx.lat_slabs(True, rows=rows):
            x = self.swin(x)
        return reslab(x[:, t0:t0 + real[r], pw // 2:pw // 2 + w], real, even, group)


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

    # the forward splits latitude over the domain ranks (see the module)
    lat_sharded = True

    def lat_split_problem(self, n: int):
        """Why the padded rows do not run on n latitude slabs, or None."""
        h = self.image_height + (sum(self.padder.pad_lat) if self.padder is not None else 0)
        if h % (n * self.patch[0]):
            return (f"model fuxi: the padded height {h} does not split into {n} slabs of "
                    f"whole {self.patch[0]}-row patches")
        return split_problem("fuxi", h // self.patch[0], self.u_transformer.window_size, n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padder is not None:
            x = self.padder.pad(x)
        b = x.shape[0]
        slabs = par_ctx.halo_mesh_active()
        if slabs:
            mesh = par_ctx.mesh()
            group, n = mesh.group("domain"), mesh.shape["domain"]
            x = shard_lat(x, n, mesh.coord("domain"))
        with par_ctx.lat_slabs(slabs):
            x = self.cube_embedding(x)
            # (B, T', H', W', dim) with T' = frames // frame_patch_size == 1
            x = x.reshape(b, x.shape[2], x.shape[3], self.dim)
            x = self.fc(self.u_transformer(x))
        ph, pw = self.patch
        hh, ww, out_c = x.shape[1], x.shape[2], self.base_output_channels
        x = x.reshape(b, hh, ww, ph, pw, out_c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, hh * ph, ww * pw, out_c)
        if slabs:  # every domain rank computes the same from here on
            x = gather_lat(x, group, same_downstream=True)
        if self.padder is not None:
            x = self.padder.unpad(x)
        if self.interp:
            x = bilinear_resize(x, self.image_height, self.image_width)
        return channels_to_frames(x, 1)

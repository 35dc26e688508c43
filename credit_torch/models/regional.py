"""Regional models: port of credit_tpu/models/regional.py (`wrf`, `dscale`).

Both run a Conv3d cube embed (a patch GEMM), FuXi's U-Transformer (3x3/s2
DownBlock, SwinV2 stage, UpBlock; only its convs carry spectral norm) and
a dense patch-recovery head, then a bilinear resize; a regional grid is
never earth-padded. `wrf` adds the driving model's state through a second
cube embed, FiLM-modulated by a time encoding, onto the interior's;
`dscale` FiLM-modulates its embedding and recovers onto the target grid
with its own channel count.

The reference creates the optional branches' parameters only when it is
called with their inputs. Here `wrf` builds `cube_embedding_outside` and
`film` when the config has `param_outside`, and `dscale` builds `film`
when `time_encode_dim` > 0; a forward without those inputs skips them, as
the trainer's (`model(x)`) does.

Under a mesh with domain > 1 both are lat-sharded after their embeds (the
cube embeds, the outside branch with its resize and the FiLM run on the
whole field: FiLM is per channel): each domain rank runs the UTransformer
on its even slab of the embedded rows (models/fuxi.py) and the dense patch
recovery on its slab, whose rows are then gathered before the resize.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from credit_torch import registry
from credit_torch.models.base import DTYPES, BaseModel, channels_to_frames
from credit_torch.models.fuxi import UTransformer, split_problem
from credit_torch.models.layers import CubeEmbedding, Dense
from credit_torch.ops.upsample import bilinear_resize
from credit_torch.parallel import context as par_ctx
from credit_torch.parallel.halo import gather_lat, shard_lat


class FiLM(nn.Module):
    """(alpha, beta), each (B, 1, 1, dim), from a flat conditioning vector."""

    def __init__(self, in_features: int, dim: int, dtype=torch.float32):
        super().__init__()
        self.film = Dense(in_features, 2 * dim, dtype=dtype, spectral=False)

    def forward(self, z):
        alpha, beta = self.film(z).chunk(2, dim=-1)
        return alpha[:, None, None, :], beta[:, None, None, :]


def _channels(p: dict, output: bool = False) -> int:
    base = int(p["channels"]) * int(p["levels"]) + int(p["surface_channels"])
    return base + int(p.get("output_only_channels" if output else "input_only_channels", 0))


def _recover(x: torch.Tensor, fc: Dense, ph: int, pw: int, out_c: int) -> torch.Tensor:
    """The dense patch recovery: (B, h, w, dim) -> (B, h ph, w pw, out_c)."""
    x = fc(x)
    b, gh, gw = x.shape[:3]
    x = x.reshape(b, gh, gw, ph, pw, out_c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * ph, gw * pw, out_c)


def _dtype(compute_dtype):
    return DTYPES[compute_dtype] if isinstance(compute_dtype, str) else compute_dtype


def _core(model, x: torch.Tensor) -> torch.Tensor:
    """The UTransformer and the patch recovery of the embedded field x
    (B, h, w, dim): on the whole field, or under a mesh with domain > 1 on
    this rank's even slab, its rows gathered after (every rank computes the
    same from there on)."""
    rec = (model.fc, *model.patch, model.base_output_channels)
    if not par_ctx.halo_mesh_active():
        return _recover(model.u_transformer(x), *rec)
    mesh = par_ctx.mesh()
    group = mesh.group("domain")
    x = shard_lat(x, mesh.shape["domain"], mesh.coord("domain"))
    with par_ctx.lat_slabs():
        x = _recover(model.u_transformer(x), *rec)
    return gather_lat(x, group, same_downstream=True)


class _Regional(BaseModel):
    # the UTransformer runs on latitude slabs under a mesh with domain > 1
    lat_sharded = True

    def lat_split_problem(self, n: int):
        """Why the embedded rows do not run on n latitude slabs, or None
        (None too where the config gives no image height)."""
        if not self.image_hw[0]:
            return None
        return split_problem(self.model_type, self.image_hw[0] // self.patch[0],
                             self.u_transformer.window_size, n)


@registry.register("model", "wrf")
class WRFTransformer(_Regional):
    """forward(x, x_outside=None, x_extra=None): x (B, frames, H, W,
    C_interior), x_outside (B, frames, H_o, W_o, C_outside), x_extra
    (B, time_encode_dim) -> (B, 1, H, W, C_target)."""

    ROUTING_KEYS = ("remat",)
    model_type = "wrf"

    def __init__(self, param_interior: Any = None, param_outside: Any = None,
                 time_encode_dim: int = 12, num_groups: int = 32, num_heads: int = 8,
                 depth: int = 4, window_size: int = 7, use_spectral_norm: bool = True,
                 interp: bool = True, compute_dtype: Any = torch.float32,
                 sn_state: bool = False, **routing):
        super().__init__()
        self._check_routing(routing)
        pi = param_interior
        self.interp, self.use_spectral_norm = interp, use_spectral_norm
        self.compute_dtype = dt = _dtype(compute_dtype)
        sn = bool(use_spectral_norm and sn_state)
        self.dim = dim = int(pi["dim"])
        self.patch = int(pi["patch_height"]), int(pi["patch_width"])
        self.image_hw = int(pi.get("image_height", 0)), int(pi.get("image_width", 0))
        self.base_input_channels = _channels(pi)
        self.base_output_channels = _channels(pi, output=True)
        frames = int(pi.get("frames", 1))
        self.cube_embedding_inside = CubeEmbedding(
            self.base_input_channels, dim,
            (int(pi.get("frame_patch_size", frames)), *self.patch), dt)
        if param_outside is not None:
            po = param_outside
            self.cube_embedding_outside = CubeEmbedding(
                _channels(po), dim, (int(po.get("frame_patch_size", frames)),
                                     int(po["patch_height"]), int(po["patch_width"])), dt)
            self.film = FiLM(time_encode_dim, dim, dt)
        else:
            self.cube_embedding_outside = self.film = None
        self.u_transformer = UTransformer(dim, num_groups, num_heads, window_size, depth, dt, sn)
        self.fc = Dense(dim, self.base_output_channels * self.patch[0] * self.patch[1],
                        dtype=dt, spectral=False)

    def forward(self, x: torch.Tensor, x_outside: Optional[torch.Tensor] = None,
                x_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, _, hh, ww, _ = x.shape
        x = self.cube_embedding_inside(x)
        x = x.reshape(b, x.shape[2], x.shape[3], self.dim)
        if x_outside is not None:
            if self.cube_embedding_outside is None:
                raise ValueError("x_outside needs the outside branch: set param_outside")
            zo = self.cube_embedding_outside(x_outside)
            zo = zo.reshape(b, zo.shape[2], zo.shape[3], self.dim)
            if zo.shape[1:3] != x.shape[1:3]:
                zo = bilinear_resize(zo, x.shape[1], x.shape[2])
            if x_extra is not None:
                alpha, beta = self.film(x_extra)
                zo = alpha * zo + beta
            x = x + zo
        x = _core(self, x)
        if self.interp:
            x = bilinear_resize(x, hh, ww)
        return channels_to_frames(x, 1)


@registry.register("model", "dscale")
class DscaleTransformer(_Regional):
    """forward(x, x_extra=None): x (B, frames, H_in, W_in,
    total_input_channels), x_extra (B, time_encode_dim) -> (B, 1,
    out_image_height, out_image_width, total_target_channels)."""

    ROUTING_KEYS = ("remat",)
    model_type = "dscale"

    def __init__(self, image_height: int = 64, image_width: int = 128,
                 out_image_height: Any = None, out_image_width: Any = None,
                 patch_height: int = 4, patch_width: int = 4, total_input_channels: int = 50,
                 total_target_channels: int = 80, time_encode_dim: int = 4, frames: int = 2,
                 frame_patch_size: int = 2, dim: int = 256, num_groups: int = 32,
                 num_heads: int = 8, depth: int = 4, window_size: int = 7,
                 use_spectral_norm: bool = True, interp: bool = True,
                 compute_dtype: Any = torch.float32, sn_state: bool = False, **routing):
        super().__init__()
        self._check_routing(routing)
        self.out_hw = (out_image_height or image_height, out_image_width or image_width)
        self.image_hw = (image_height, image_width)
        self.interp, self.use_spectral_norm = interp, use_spectral_norm
        self.compute_dtype = dt = _dtype(compute_dtype)
        sn = bool(use_spectral_norm and sn_state)
        self.dim, self.patch = dim, (patch_height, patch_width)
        self.base_input_channels = total_input_channels
        self.base_output_channels = total_target_channels
        self.cube_embedding = CubeEmbedding(total_input_channels, dim,
                                            (frame_patch_size, patch_height, patch_width), dt)
        self.film = FiLM(time_encode_dim, dim, dt) if time_encode_dim > 0 else None
        self.u_transformer = UTransformer(dim, num_groups, num_heads, window_size, depth, dt, sn)
        self.fc = Dense(dim, total_target_channels * patch_height * patch_width, dtype=dt,
                        spectral=False)

    def forward(self, x: torch.Tensor, x_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = x.shape[0]
        x = self.cube_embedding(x)
        x = x.reshape(b, x.shape[2], x.shape[3], self.dim)
        if x_extra is not None:
            alpha, beta = self.film(x_extra)
            x = alpha * x + beta
        x = _core(self, x)
        if self.interp:
            x = bilinear_resize(x, *self.out_hw)
        return channels_to_frames(x, 1)

"""WXFormer / CrossFormer forward: port of credit_tpu/models/crossformer.py,
on folded kernels or with spectral-norm state (`sn_state=True`, training).

Order: earth pad, frames to channels (or, with patches larger than 1x1,
the Conv3d cube embed over all frames), four (cross-embed, transformer)
stages, three UpBlocks with U-Net skip concats and the ConvTranspose
k4/s2/p1 head (or, with `upsample_with_ps`, three UpBlockPS, a 3x3
sub-pixel conv, pixel shuffle and a 3x3 refine conv), camulator's
zero-initialised 3x3 `sharp` residual (`sharp_skip`, no spectral norm),
unpad with the original pad sizes, bilinear recovery of the native grid
(or of `out_image_height/width`), channels to frames. Input
(B, T, H, W, C_in), output (B, T_out, H, W, C_out).

Under a mesh with domain > 1 (`parallel.context.explicit_halo`) the
forward is lat-sharded (`_forward_slabs`, which crossformer-ensemble's
forward shares): the earth padding (and the cube embed) run on the whole
field, each domain rank then keeps its latitude slab of the padded grid.
A stage runs on slabs while its output rows split evenly over the ranks,
and on the whole field (gathered) from the first that does not, until an
up-block's output splits again; the skips are cut or gathered to match. The last decoder output is gathered (each rank then computes the
same unpad, bilinear recovery and loss), so every domain rank returns the
whole prediction.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from credit_torch import registry
from credit_torch.models.base import DTYPES, BaseModel, channels_to_frames, frames_to_channels
from credit_torch.models.layers import (Conv, ConvTranspose, CrossEmbedLayer, CubeEmbedding,
                                        Transformer, UpBlock, UpBlockPS)
from credit_torch.parallel import context as par_ctx
from credit_torch.ops.padding import TensorPadding
from credit_torch.ops.upsample import bilinear_resize, pixel_shuffle


def _tup(v, n=4):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


@registry.register("model", "crossformer")
@registry.register("model", "wxformer")
class CrossFormer(BaseModel):
    """Constructor arguments mirror the reference config's model keys.
    `use_spectral_norm` says whether the weights carry spectral norm. With
    `sn_state=False` (inference) it is folded into the kernels (see
    convert_jax); with `sn_state=True` every SN layer holds its u/v buffers
    and normalizes its kernel at each forward, iterating in `train()` mode."""

    ROUTING_KEYS = ("pallas_conv", "ff_fusion", "use_pallas_attention", "scan_blocks", "remat")

    def __init__(self, image_height: int = 640, image_width: int = 1280,
                 patch_height: int = 1, patch_width: int = 1, frames: int = 2,
                 output_frames: int = 1, channels: int = 4, surface_channels: int = 7,
                 input_only_channels: int = 3, output_only_channels: int = 0,
                 levels: int = 15, dim: Sequence[int] = (64, 128, 256, 512),
                 depth: Sequence[int] = (2, 2, 8, 2), dim_head: int = 32,
                 global_window_size: Sequence[int] = (5, 5, 2, 1), local_window_size: Any = 10,
                 cross_embed_kernel_sizes: Sequence = ((4, 8, 16, 32), (2, 4), (2, 4), (2, 4)),
                 cross_embed_strides: Sequence[int] = (4, 2, 2, 2),
                 use_spectral_norm: bool = True, interp: bool = True,
                 upsample_with_ps: bool = False, padding_conf: Any = None,
                 use_interp: bool = True, compute_dtype: Any = torch.float32,
                 sharp_skip: bool = False, out_image_height: Any = None,
                 out_image_width: Any = None, sn_state: bool = False, **routing):
        super().__init__()
        self._check_routing(routing)
        if isinstance(compute_dtype, str):
            compute_dtype = DTYPES[compute_dtype]
        self.image_height, self.image_width = image_height, image_width
        self.out_image_height, self.out_image_width = out_image_height, out_image_width
        self.output_frames = output_frames
        self.interp = interp
        self.use_spectral_norm = use_spectral_norm
        self.compute_dtype = dt = compute_dtype
        sn = bool(use_spectral_norm and sn_state)
        self.base_input_channels = channels * levels + surface_channels + input_only_channels
        self.base_output_channels = channels * levels + surface_channels + output_only_channels

        self.dims = dims = _tup(dim)
        depths = _tup(depth)
        gws, lws = _tup(global_window_size), _tup(local_window_size)
        self.strides = strides = _tup(cross_embed_strides)
        ksizes = tuple(tuple(k) for k in cross_embed_kernel_sizes)
        pconf = padding_conf or {"activate": False}
        self.padder = TensorPadding(**pconf) if pconf.get("activate") else None

        c = self.stacked_input_channels() * frames
        self.cube = patch_height > 1 and patch_width > 1
        if self.cube:
            self.cube_embedding = CubeEmbedding(self.stacked_input_channels(), dims[0],
                                                (frames, patch_height, patch_width), dt)
            c = dims[0]  # one embedded frame: dims[0] * (frames // frames)
        for i in range(4):
            self.add_module(f"cel{i}", CrossEmbedLayer(c, dims[i], ksizes[i], strides[i], dt, sn))
            self.add_module(f"transformer{i}",
                            Transformer(dims[i], depths[i], lws[i], gws[i], dim_head, dt, sn))
            c = dims[i]
        last, ng = dims[-1], dims[0]
        self.upsample_with_ps = upsample_with_ps
        up = UpBlockPS if upsample_with_ps else UpBlock
        self.up_block1 = up(last, last // 2, ng, dtype=dt, sn=sn)
        self.up_block2 = up(last // 2 + dims[2], last // 4, ng, dtype=dt, sn=sn)
        self.up_block3 = up(last // 4 + dims[1], last // 8, ng, dtype=dt, sn=sn)
        out_ch = self.base_output_channels * output_frames
        if upsample_with_ps:
            self.up4_ps_conv = Conv(last // 8 + dims[0], out_ch * 4, 3, 1, 1, dt, sn,
                                    kernel_init=("icnr", 2))
            self.up4_refine = Conv(out_ch, out_ch, 3, 1, 1, dt, sn)
        else:
            self.up_block4 = ConvTranspose(last // 8 + dims[0], out_ch, 4, 2, 1, dt, sn)
        # camulator: identity at init, a sharpening residual free of the
        # spectral-norm Lipschitz cap
        self.sharp = (Conv(out_ch, out_ch, 3, 1, 1, dt, spectral=False,
                           kernel_init=("zeros",)) if sharp_skip else None)

    def stacked_input_channels(self) -> int:
        """Channels of one input frame as the encoder sees it."""
        return self.base_input_channels

    # the forward splits latitude over the domain ranks (_forward_slabs); a
    # subclass with a forward of its own that does not sets this False
    lat_sharded = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if par_ctx.halo_mesh_active():
            return self._forward_slabs(x)
        if self.padder is not None:
            x = self.padder.pad(x)
        if self.cube:
            x = self.cube_embedding(x)  # (B, 1, H', W', dim0)
        x = frames_to_channels(x)
        encodings = []
        for i in range(4):
            x = getattr(self, f"cel{i}")(x)
            x = getattr(self, f"transformer{i}")(x)
            encodings.append(x)
        x = self.up_block1(x)
        x = torch.cat([x, encodings[2]], dim=-1)
        x = self.up_block2(x)
        x = torch.cat([x, encodings[1]], dim=-1)
        x = self.up_block3(x)
        x = torch.cat([x, encodings[0]], dim=-1)
        if self.upsample_with_ps:
            x = self.up4_refine(pixel_shuffle(self.up4_ps_conv(x), 2))
        else:
            x = self.up_block4(x)
        if self.sharp is not None:
            x = x + self.sharp(x)
        if self.padder is not None:
            # unpad with the original pad sizes even when the encoder/decoder
            # round trip changed the grid; the resize recovers the native grid
            x = self.padder.unpad(x)
        if self.interp:
            x = bilinear_resize(x, self.out_image_height or self.image_height,
                                self.out_image_width or self.image_width)
        return channels_to_frames(x, self.output_frames)

    def _forward_slabs(self, x: torch.Tensor, inject=None, out_hw=None) -> torch.Tensor:
        """forward with latitude split over the mesh's domain ranks (see
        the module); the same function of x on every domain rank.
        `inject(point, t, on_slabs) -> t` is called on the encoder skips
        ("skip2", "skip1", "skip0") after the encoder, then on the
        up-blocks' outputs ("up1" to "up3"), with whether t is a slab (the
        ensemble's noise injection); `out_hw` is the bilinear recovery's
        grid, (out_image_height or image_height, ...) by default."""
        from credit_torch.parallel.halo import gather_lat, scale_grad, shard_lat

        group, n, r = par_ctx.mesh_domain()
        if self.padder is not None:
            x = self.padder.pad(x)
        if self.cube:
            x = self.cube_embedding(x)
        x = frames_to_channels(x)
        sh = x.shape[1] % n == 0
        if sh:
            x = shard_lat(x, n, r)

        def run(fn, t, on_slabs):
            with par_ctx.lat_slabs(on_slabs):
                return fn(t)

        encodings = []
        for i in range(4):
            rows = x.shape[1] * n if sh else x.shape[1]
            if sh and (rows % self.strides[i] or (rows // self.strides[i]) % n):
                x, sh = par_ctx.gather_whole(x, group, "stage"), False  # rows do not split
            x = run(getattr(self, f"cel{i}"), x, sh)
            x = run(getattr(self, f"transformer{i}"), x, sh)
            encodings.append((x, sh))
        if inject is not None:
            for i in (2, 1, 0):
                e, e_sh = encodings[i]
                encodings[i] = (inject(f"skip{i}", e, e_sh), e_sh)

        def up(i, t, t_sh):
            t = run(getattr(self, f"up_block{i}"), t, t_sh)
            return t if inject is None else inject(f"up{i}", t, t_sh)

        def join(t, t_sh, skip):
            e, e_sh = skip
            if t_sh and not e_sh:
                t, t_sh = par_ctx.gather_whole(t, group, "join"), False
            elif e_sh and not t_sh:
                t, t_sh = shard_lat(t, n, r), True
            return torch.cat([t, e], dim=-1), t_sh

        x, sh = join(up(1, x, sh), sh, encodings[2])
        x, sh = join(up(2, x, sh), sh, encodings[1])
        x, sh = join(up(3, x, sh), sh, encodings[0])

        def head(t):
            if self.upsample_with_ps:
                t = self.up4_refine(pixel_shuffle(self.up4_ps_conv(t), 2))
            else:
                t = self.up_block4(t)
            return t + self.sharp(t) if self.sharp is not None else t

        x = run(head, x, sh)
        # every domain rank computes the same from here on: a gather whose
        # backward keeps this rank's rows, or (a whole field already) each
        # rank's gradient counted once in the sum over the ranks
        x = gather_lat(x, group, same_downstream=True) if sh else scale_grad(x, 1.0 / n)
        if self.padder is not None:
            x = self.padder.unpad(x)
        if self.interp:
            x = bilinear_resize(x, *(out_hw or (self.out_image_height or self.image_height,
                                                self.out_image_width or self.image_width)))
        return channels_to_frames(x, self.output_frames)

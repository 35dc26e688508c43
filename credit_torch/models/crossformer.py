"""WXFormer / CrossFormer forward on folded kernels: port of
credit_tpu/models/crossformer.py.

Order: earth pad, frames to channels, four (cross-embed, transformer)
stages, three UpBlocks with U-Net skip concats, the ConvTranspose k4/s2/p1
head, unpad with the original pad sizes, bilinear recovery of the native
grid, channels to frames. Input (B, T, H, W, C_in), output
(B, T_out, H, W, C_out).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from credit_torch import registry
from credit_torch.models.base import channels_to_frames, frames_to_channels
from credit_torch.models.layers import ConvTranspose, CrossEmbedLayer, Transformer, UpBlock
from credit_torch.ops.padding import TensorPadding
from credit_torch.ops.upsample import bilinear_resize

# TPU routing switches of the reference model; on CUDA the port always takes
# its kernels, so these are accepted and ignored
TPU_ROUTING_KEYS = ("pallas_conv", "ff_fusion", "use_pallas_attention", "scan_blocks", "remat")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tup(v, n=4):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


@registry.register("model", "crossformer")
@registry.register("model", "wxformer")
class CrossFormer(nn.Module):
    """Constructor arguments mirror the reference config's model keys.
    `use_spectral_norm` says whether the weights carry spectral norm: the
    port always runs them folded (see convert_jax)."""

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
                 out_image_width: Any = None, **routing):
        super().__init__()
        unknown = set(routing) - set(TPU_ROUTING_KEYS)
        if unknown:
            raise TypeError(f"CrossFormer: unexpected arguments {sorted(unknown)}")
        if patch_height > 1 and patch_width > 1:
            raise NotImplementedError("CubeEmbedding is not ported yet (ROADMAP queue 1, item 3)")
        if upsample_with_ps:
            raise NotImplementedError("UpBlockPS is not ported yet (ROADMAP queue 1, item 3)")
        if sharp_skip:
            raise NotImplementedError("the sharp skip conv is not ported yet (ROADMAP queue 1, item 3)")
        if isinstance(compute_dtype, str):
            compute_dtype = DTYPES[compute_dtype]
        self.image_height, self.image_width = image_height, image_width
        self.out_image_height, self.out_image_width = out_image_height, out_image_width
        self.output_frames = output_frames
        self.interp = interp
        self.use_spectral_norm = use_spectral_norm
        self.compute_dtype = dt = compute_dtype
        self.base_input_channels = channels * levels + surface_channels + input_only_channels
        self.base_output_channels = channels * levels + surface_channels + output_only_channels

        dims, depths = _tup(dim), _tup(depth)
        gws, lws = _tup(global_window_size), _tup(local_window_size)
        strides = _tup(cross_embed_strides)
        ksizes = tuple(tuple(k) for k in cross_embed_kernel_sizes)
        pconf = padding_conf or {"activate": False}
        self.padder = TensorPadding(**pconf) if pconf.get("activate") else None

        c = self.base_input_channels * frames
        for i in range(4):
            self.add_module(f"cel{i}", CrossEmbedLayer(c, dims[i], ksizes[i], strides[i], dt))
            self.add_module(f"transformer{i}",
                            Transformer(dims[i], depths[i], lws[i], gws[i], dim_head, dt))
            c = dims[i]
        last, ng = dims[-1], dims[0]
        self.up_block1 = UpBlock(last, last // 2, ng, dtype=dt)
        self.up_block2 = UpBlock(last // 2 + dims[2], last // 4, ng, dtype=dt)
        self.up_block3 = UpBlock(last // 4 + dims[1], last // 8, ng, dtype=dt)
        out_ch = self.base_output_channels * output_frames
        self.up_block4 = ConvTranspose(last // 8 + dims[0], out_ch, 4, 2, 1, dt)

    @classmethod
    def from_config(cls, conf: dict) -> "CrossFormer":
        """Build from a gen2 config dict; model-section keys that are not
        constructor arguments are ignored, as in the reference."""
        import inspect

        names = set(inspect.signature(cls.__init__).parameters) | set(TPU_ROUTING_KEYS)
        mconf = {k: v for k, v in conf["model"].items() if k in names and k != "type"}
        return cls(**mconf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padder is not None:
            x = self.padder.pad(x)
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
        x = self.up_block4(x)
        if self.padder is not None:
            # unpad with the original pad sizes even when the encoder/decoder
            # round trip changed the grid; the resize recovers the native grid
            x = self.padder.unpad(x)
        if self.interp:
            x = bilinear_resize(x, self.out_image_height or self.image_height,
                                self.out_image_width or self.image_width)
        return channels_to_frames(x, self.output_frames)

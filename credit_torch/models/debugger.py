"""Shape-echo debugger model: port of credit_tpu/models/debugger.py.

(B, T, H, W, C_in) -> (B, T_out, H, W, C_out) through one Dense layer on
the stacked frames, so a data, training or rollout pipeline runs cheaply.
Under a mesh with domain > 1 each domain rank projects its latitude slab
and the slabs are gathered (every rank returns the whole prediction).
"""

from __future__ import annotations

from typing import Any

import torch

from credit_torch import registry
from credit_torch.models.base import DTYPES, BaseModel, channels_to_frames, frames_to_channels
from credit_torch.models.layers import Dense
from credit_torch.parallel import context as par_ctx


@registry.register("model", "debugger")
class DebuggerModel(BaseModel):
    def __init__(self, image_height: int = 181, image_width: int = 360, frames: int = 1,
                 output_frames: int = 1, channels: int = 4, surface_channels: int = 4,
                 input_only_channels: int = 4, output_only_channels: int = 0, levels: int = 18,
                 compute_dtype: Any = torch.float32, sn_state: bool = False):
        super().__init__()
        if isinstance(compute_dtype, str):
            compute_dtype = DTYPES[compute_dtype]
        self.output_frames = output_frames
        self.base_input_channels = channels * levels + surface_channels + input_only_channels
        self.base_output_channels = channels * levels + surface_channels + output_only_channels
        self.proj = Dense(self.base_input_channels * frames,
                          self.base_output_channels * output_frames, dtype=compute_dtype,
                          spectral=False)

    lat_sharded = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if par_ctx.halo_mesh_active():
            return self._forward_slabs(x)
        return channels_to_frames(self.proj(frames_to_channels(x)), self.output_frames)

    def _forward_slabs(self, x: torch.Tensor) -> torch.Tensor:
        from credit_torch.parallel.halo import gather_lat, scale_grad, shard_lat

        group, n, r = par_ctx.mesh_domain()
        if x.shape[2] % n:  # rows that do not split: the whole field on every rank
            y = scale_grad(self.proj(frames_to_channels(x)), 1.0 / n)
            return channels_to_frames(y, self.output_frames)
        y = self.proj(frames_to_channels(shard_lat(x, n, r)))
        return channels_to_frames(gather_lat(y, group, same_downstream=True), self.output_frames)

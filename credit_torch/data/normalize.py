"""Per-channel z-score normalization aligned to a ChannelSchema (port of
credit_tpu/data/normalize.py; reference: the Normalize_ERA5_and_Forcing
transform, credit/transforms/transforms_global.py:21, and the gen2
era5_normalizer preblock, credit/preblock/norm.py:35).

Mean and std per channel (per level for 3-D variables) are 1-D f32
tensors on the CPU; each method uses a copy on its data's device, made once
per device, so one Normalizer serves data on any device. That is also what sets the dtypes: a bf16 tensor minus or times a
1-D f32 tensor is f32 in torch, as bf16 with f32 is in jnp, so a bf16
model output leaves `denormalize_target` in f32, as in the reference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from credit_torch.data.channels import ChannelSchema


def _stats(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).reshape(-1)


class Normalizer:
    def __init__(self, input_mean, input_std, target_mean, target_std):
        self.input_mean = _stats(input_mean)
        self.input_std = _stats(input_std)
        self.target_mean = _stats(target_mean)
        self.target_std = _stats(target_std)
        self._on_device = {}

    def _stat(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The statistic `name` on t's device."""
        key = (name, t.device)
        if key not in self._on_device:
            self._on_device[key] = getattr(self, name).to(t.device)
        return self._on_device[key]

    # channels-last: stats broadcast over (..., C)
    def normalize_input(self, x):
        return (x - self._stat("input_mean", x)) / self._stat("input_std", x)

    def normalize_target(self, y):
        return (y - self._stat("target_mean", y)) / self._stat("target_std", y)

    def denormalize_target(self, y):
        return y * self._stat("target_std", y) + self._stat("target_mean", y)

    def denormalize_input(self, x):
        """Inverse of normalize_input."""
        return x * self._stat("input_std", x) + self._stat("input_mean", x)

    def normalize_forcing(self, f, schema: ChannelSchema):
        """Normalize a dynamic-forcing slice with its input-channel stats
        (forcing splices into the normalized input at rollout time)."""
        idx = schema.dynamic_forcing_indices()
        if not idx:
            return f
        idx = torch.as_tensor(idx, device=f.device)
        return (f - self._stat("input_mean", f)[idx]) / self._stat("input_std", f)[idx]

    @classmethod
    def identity(cls, schema: ChannelSchema) -> "Normalizer":
        return cls(
            np.zeros(schema.n_input), np.ones(schema.n_input),
            np.zeros(schema.n_target), np.ones(schema.n_target),
        )

    @classmethod
    def from_stats_dict(cls, schema: ChannelSchema,
                        mean: Dict[str, np.ndarray],
                        std: Dict[str, np.ndarray]) -> "Normalizer":
        """mean/std keyed by base variable name; 3-D variables map level-wise
        arrays, 2-D scalars. Channels not present in the dicts (e.g. static
        masks already normalized) get (0, 1)."""

        def stat(entries, table, default):
            out = np.full(len(entries), default, np.float32)
            for e in entries:
                base, _, lev = e.name.rpartition("_L")
                if base and lev.isdigit() and base in table:
                    arr = np.atleast_1d(np.asarray(table[base], np.float32))
                    out[e.index] = arr[int(lev)] if arr.size > 1 else arr[0]
                elif e.name in table:
                    out[e.index] = np.asarray(table[e.name], np.float32).reshape(-1)[0]
            return out

        return cls(
            stat(schema.input_entries, mean, 0.0),
            stat(schema.input_entries, std, 1.0),
            stat(schema.target_entries, mean, 0.0),
            stat(schema.target_entries, std, 1.0),
        )

    @classmethod
    def from_netcdf(cls, schema: ChannelSchema, mean_path: str, std_path: str,
                    level_coord: str = "level") -> "Normalizer":
        """Load mean/std from the reference's mean/std netCDF files: not
        ported yet."""
        raise NotImplementedError(
            "Normalizer.from_netcdf is not ported yet: its netCDF reader (utils/ncio) comes "
            "with the data pipeline (ROADMAP queue 1, item 12); build the Normalizer with "
            "from_stats_dict")

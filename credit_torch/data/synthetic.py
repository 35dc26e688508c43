"""Synthetic ERA5-like dataset: deterministic smooth fields per timestamp;
the port's copy of credit_tpu/data/synthetic.py.

Fills the role of the reference's tiny-fixture datasets for smoke and
benchmark runs (credit_smoke_test_v2.yml with synthetic or local data).
Fields are band-limited
random spherical-ish patterns, deterministic in (time index, channel), so
multi-process / multi-host loaders agree without communication.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from credit_torch.data.channels import ChannelSchema
from credit_torch.grid import Grid


class SyntheticDataset:
    """Maps (time_index, step) -> dict of flat input/target arrays.

    Sample layout matches what the trainer/rollout consume:
      x:        (T_hist, lat, lon, C_in)
      y:        (T_out,  lat, lon, C_target)
      dynamic_forcing at step k: (T, lat, lon, n_dyn)
    """

    def __init__(self, schema: ChannelSchema, grid: Grid, history_len: int = 1,
                 n_times: int = 64, seed: int = 0, kmax: int = 4):
        self.schema = schema
        self.grid = grid
        self.history_len = history_len
        self.n_times = n_times
        self.seed = seed
        self.kmax = kmax
        lat = np.deg2rad(grid.lat)
        lon = np.deg2rad(grid.lon)
        self._lat, self._lon = np.meshgrid(lat, lon, indexing="ij")

    def __len__(self):
        return self.n_times

    def _field(self, t_idx: int, c_idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1000003 + c_idx)
        k = self.kmax
        amps = rng.standard_normal((k, k, 2)) / (1 + np.arange(k)[:, None, None])
        phase_speed = rng.uniform(0.1, 0.5, (k, k))
        f = np.zeros_like(self._lat, dtype=np.float64)
        for i in range(k):
            for j in range(k):
                ph = phase_speed[i, j] * t_idx
                f += amps[i, j, 0] * np.cos((i + 1) * self._lat) * np.cos(j * self._lon + ph)
                f += amps[i, j, 1] * np.cos((i + 1) * self._lat) * np.sin(j * self._lon + ph)
        return f.astype(np.float32)

    def _stack(self, t_idx: int, entries) -> np.ndarray:
        return np.stack([self._field(t_idx, e.index + (0 if e.field_type != "diagnostic" else 10000))
                         for e in entries], axis=-1)

    def input_at(self, t_idx: int) -> np.ndarray:
        frames = [self._stack(t_idx - k, self.schema.input_entries)
                  for k in reversed(range(self.history_len))]
        return np.stack(frames, axis=0)  # (T_hist, lat, lon, C_in)

    def target_at(self, t_idx: int) -> np.ndarray:
        return self._stack(t_idx, self.schema.target_entries)[None]  # (1, lat, lon, C_t)

    def forcing_at(self, t_idx: int) -> Optional[np.ndarray]:
        idx = self.schema.dynamic_forcing_indices()
        if not idx:
            return None
        ents = [self.schema.input_entries[i] for i in idx]
        return self._stack(t_idx, ents)[None]  # (1, lat, lon, n_dyn)

    def sample(self, t_idx: int, n_steps: int = 1) -> Dict[str, np.ndarray]:
        """One multi-step training sample starting at t_idx."""
        return {
            "x": self.input_at(t_idx),
            "y": np.concatenate([self.target_at(t_idx + 1 + s) for s in range(n_steps)], axis=0),
            "forcing": None if self.forcing_at(t_idx) is None else np.concatenate(
                [self.forcing_at(t_idx + 1 + s) for s in range(n_steps)], axis=0),
        }

    def batch(self, t_indices, n_steps: int = 1) -> Dict[str, np.ndarray]:
        samples = [self.sample(t, n_steps) for t in t_indices]
        out = {
            "x": np.stack([s["x"] for s in samples]),
            "y": np.stack([s["y"] for s in samples]),
        }
        if samples[0]["forcing"] is not None:
            out["forcing"] = np.stack([s["forcing"] for s in samples])
        return out

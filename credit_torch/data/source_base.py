"""Shared clocked-source sample API: the port's copy of
credit_tpu/data/source_base.py.

Every gen2-style source dataset (zarr store, file granules, synthetic)
assembles the same flat channels-last tensors on a CF-calendar master clock
(reference: credit/datasets/gen_2/base_dataset.py:41 AbstractBaseDataset /
:120 BaseDataset — __getitem__((timestamp, step)) over the field-type
taxonomy). Subclasses provide `_read_var(base_name, t_idx, is_static)`
returning (lat, lon) or (lat, lon, L); this mixin supplies channel
stacking, the input/target/forcing views, and sample/batch assembly.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class ClockedSource:
    """Requires attributes: schema, source, history_len, clock."""

    # -- clock addressing --------------------------------------------------
    def __len__(self):
        return len(self.clock.all_times)

    def init_times(self) -> List:
        """Valid init datetimes (history/forecast margins respected)."""
        return list(self.clock.init_times)

    def time_of(self, t_idx: int):
        return self.clock.time_at(t_idx)

    def index_of(self, when) -> int:
        return self.clock.index_of(when)

    # -- channel assembly --------------------------------------------------
    def _read_var(self, base_name: str, t_idx: int, is_static: bool
                  ) -> np.ndarray:
        raise NotImplementedError

    def _stack(self, t_idx: int, entries) -> np.ndarray:
        cols, cache = [], {}
        for e in entries:
            if self.source is not None and e.source != self.source:
                raise KeyError(
                    f"entry {e.name} belongs to source {e.source}; this "
                    f"dataset serves {self.source} (use MultiSourceDataset)")
            base, sep, lev = e.name.rpartition("_L")
            is_static = e.field_type == "static"
            if sep and lev.isdigit():
                if base not in cache:
                    cache[base] = self._read_var(base, t_idx, is_static)
                cols.append(cache[base][..., int(lev)])
            else:
                cols.append(self._read_var(e.name, t_idx, is_static))
        return np.stack(cols, axis=-1).astype(np.float32)

    # -- sample API (identical across sources) ------------------------------
    def input_at(self, t_idx: int) -> np.ndarray:
        frames = [self._stack(t_idx - k, self.schema.input_entries)
                  for k in reversed(range(self.history_len))]
        return np.stack(frames, axis=0)

    def target_at(self, t_idx: int) -> np.ndarray:
        return self._stack(t_idx, self.schema.target_entries)[None]

    def forcing_at(self, t_idx: int) -> Optional[np.ndarray]:
        idx = self.schema.dynamic_forcing_indices()
        if not idx:
            return None
        ents = [self.schema.input_entries[i] for i in idx]
        return self._stack(t_idx, ents)[None]

    def sample(self, t_idx: int, n_steps: int = 1):
        out = {
            "x": self.input_at(t_idx),
            "y": np.concatenate([self.target_at(t_idx + 1 + s)
                                 for s in range(n_steps)], axis=0),
        }
        f = self.forcing_at(t_idx)
        out["forcing"] = None if f is None else np.concatenate(
            [self.forcing_at(t_idx + 1 + s) for s in range(n_steps)], axis=0)
        return out

    def batch(self, t_indices, n_steps: int = 1):
        samples = [self.sample(int(t), n_steps) for t in t_indices]
        out = {"x": np.stack([s["x"] for s in samples]),
               "y": np.stack([s["y"] for s in samples])}
        if samples[0].get("forcing") is not None:
            out["forcing"] = np.stack([s["forcing"] for s in samples])
        return out

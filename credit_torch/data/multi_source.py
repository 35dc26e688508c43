"""Multi-source dataset: compose per-source datasets on a master clock;
the port's copy of credit_tpu/data/multi_source.py.

Re-implements the reference's MultiSourceDataset (reference:
credit/datasets/gen_2/multi_source.py:142 — routes each config source to a
dataset class via a registry, merges nested samples on a shared clock). In
the flat-tensor design the merge is channel concatenation: the global
ChannelSchema lays sources out contiguously in config order, so each
sub-dataset fills exactly its source's channel block.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from credit_torch.data.channels import ChannelSchema


def _sub_schema(schema: ChannelSchema, source: str) -> ChannelSchema:
    """A per-source view of the global schema with re-based indices."""
    from credit_torch.data.channels import ChannelEntry, _field_slices

    ins = [ChannelEntry(e.name, e.source, e.field_type, i)
           for i, e in enumerate(e2 for e2 in schema.input_entries
                                 if e2.source == source)]
    tgts = [ChannelEntry(e.name, e.source, e.field_type, i)
            for i, e in enumerate(e2 for e2 in schema.target_entries
                                  if e2.source == source)]
    return ChannelSchema(ins, tgts, _field_slices(ins), _field_slices(tgts),
                         schema.n_levels)


class MultiSourceDataset:
    """Compose {source_name: sub_dataset}; sub-datasets expose the same
    sample API (input_at/target_at/forcing_at) on their per-source schemas
    and must share the clock (same length / time indexing)."""

    def __init__(self, schema: ChannelSchema, sources: Dict[str, object],
                 history_len: int = 1):
        self.schema = schema
        self.sources = sources
        self.history_len = history_len
        self.source_order = []
        seen = set()
        for e in schema.input_entries + schema.target_entries:
            if e.source not in seen:
                seen.add(e.source)
                self.source_order.append(e.source)
        missing = [s for s in self.source_order if s not in sources]
        if missing:
            raise KeyError(f"no dataset provided for sources {missing}")
        lengths = {len(ds) for ds in sources.values()}
        if len(lengths) > 1:
            raise ValueError(f"sources disagree on clock length: {lengths}")
        # datetime-clocked sources must agree on the master clock
        clocks = [ds.clock for ds in sources.values() if hasattr(ds, "clock")]
        for c in clocks[1:]:
            if (str(c.time_at(0)) != str(clocks[0].time_at(0))
                    or c.dt != clocks[0].dt):
                raise ValueError(
                    f"source clocks disagree: {c.time_at(0)}@{c.dt} vs "
                    f"{clocks[0].time_at(0)}@{clocks[0].dt}")

    def __len__(self):
        return len(next(iter(self.sources.values())))

    def input_at(self, t_idx: int) -> np.ndarray:
        return np.concatenate(
            [self.sources[s].input_at(t_idx) for s in self.source_order], axis=-1)

    def target_at(self, t_idx: int) -> np.ndarray:
        return np.concatenate(
            [self.sources[s].target_at(t_idx) for s in self.source_order], axis=-1)

    def forcing_at(self, t_idx: int) -> Optional[np.ndarray]:
        parts = [self.sources[s].forcing_at(t_idx) for s in self.source_order]
        parts = [p for p in parts if p is not None]
        return np.concatenate(parts, axis=-1) if parts else None

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


def build_multi_source(conf: dict, schema: ChannelSchema, grid,
                       split: str = "train") -> MultiSourceDataset:
    """Route each config source to its dataset class
    (reference: multi_source.py:99 route_to_dataset_class)."""
    from credit_torch.data.synthetic import SyntheticDataset

    data = conf.get("data", {}) or {}
    dconf = conf.get("data_valid", data) if split == "valid" else data
    history_len = int(dconf.get("history_len", 1)) or 1
    subs = {}
    for name, src in (dconf.get("source") or {}).items():
        sub_schema = _sub_schema(schema, name)
        dtype = src.get("dataset_type",
                        "synthetic" if not src.get("path") else "local")
        if dtype == "synthetic":
            subs[name] = SyntheticDataset(
                sub_schema, grid, history_len=history_len,
                n_times=int(dconf.get("n_times", 64)),
                seed=int(conf.get("seed", 0)))
        else:
            from credit_torch.data.local import build_source_dataset

            subs[name] = build_source_dataset(dtype, sub_schema, src, dconf,
                                              name, grid, history_len)
    return MultiSourceDataset(schema, subs, history_len)

"""Local file-backed dataset (netCDF or .npz snapshots) and the dataset
dispatch: the port's copy of credit_tpu/data/local.py.

Fills the role of the reference's gen2 LocalDataset
(reference: credit/datasets/gen_2/local.py — zarr/netCDF per-variable reads
on a master clock). Files readable via credit_torch.utils.ncio (netCDF-3)
or numpy .npz are supported, one file per timestamp. Zarr sources
(`data/era5.py`), the observation granules (`data/obs.py`: goes, hrrr,
mrms) and the computed solar forcing (`data/tisr.py`) plug in through the
same interface.
"""

from __future__ import annotations

import glob
from typing import Dict, List, Optional

import numpy as np

from credit_torch.data.channels import ChannelSchema
from credit_torch import registry


@registry.register("dataset", "local")
class LocalDataset:
    """Directory of per-time files; variables resolved via the schema.

    Files: sorted glob of `path`; each file holds 2-D vars as (lat, lon) and
    3-D vars as (lev, lat, lon) arrays keyed by variable name.
    Provides the same sample API as SyntheticDataset (input_at/target_at/
    forcing_at/sample/batch).
    """

    def __init__(self, schema: ChannelSchema, path: str, history_len: int = 1,
                 file_format: Optional[str] = None):
        self.schema = schema
        self.history_len = history_len
        self.files: List[str] = sorted(glob.glob(path))
        if not self.files:
            raise FileNotFoundError(f"no files match {path}")
        self.fmt = file_format or ("npz" if self.files[0].endswith(".npz") else "nc")
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self):
        return len(self.files)

    def _load(self, t_idx: int) -> Dict[str, np.ndarray]:
        if t_idx in self._cache:
            return self._cache[t_idx]
        path = self.files[t_idx]
        if self.fmt == "npz":
            with np.load(path) as z:
                data = {k: np.asarray(z[k]) for k in z.files}
        else:
            from credit_torch.utils.ncio import open_dataset

            ds = open_dataset(path)
            data = {k: np.asarray(ds[k].values) for k in ds.keys()}
        if len(self._cache) > 8:
            self._cache.pop(next(iter(self._cache)))
        self._cache[t_idx] = data
        return data

    def _field(self, data: Dict[str, np.ndarray], name: str) -> np.ndarray:
        base, sep, lev = name.rpartition("_L")
        if sep and lev.isdigit() and base in data:
            return data[base][int(lev)]
        if name in data:
            arr = data[name]
            return arr[0] if arr.ndim == 3 and arr.shape[0] == 1 else arr
        raise KeyError(f"variable {name} not found in file (have {sorted(data)})")

    def _stack(self, t_idx: int, entries) -> np.ndarray:
        data = self._load(t_idx)
        return np.stack([self._field(data, e.name) for e in entries], axis=-1).astype(np.float32)

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
            "y": np.concatenate([self.target_at(t_idx + 1 + s) for s in range(n_steps)], axis=0),
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


def load_dataset(conf: dict, schema: ChannelSchema, grid, split: str = "train"):
    """Dataset dispatch (reference: credit/trainers/utils.py:444 load_dataset
    + the gen2 _SOURCE_REGISTRY routing, multi_source.py:65)."""
    from credit_torch.data.synthetic import SyntheticDataset

    data = conf.get("data", {}) or {}
    dconf = conf.get("data_valid", data) if split == "valid" else data
    history_len = int(dconf.get("history_len", 1)) or 1
    sources = dconf.get("source") or {"ERA5": {}}
    if len(sources) > 1:
        from credit_torch.data.multi_source import build_multi_source

        return build_multi_source(conf, schema, grid, split)
    name, src = next(iter(sources.items()))
    dtype = src.get("dataset_type", "synthetic" if not src.get("path") else "local")
    if dtype == "synthetic":
        return SyntheticDataset(schema, grid, history_len=history_len,
                                n_times=int(dconf.get("n_times", 64)),
                                seed=int(conf.get("seed", 0)))
    return build_source_dataset(dtype, schema, src, dconf, name, grid,
                                history_len)


# "HRRR" is registered beside "hrrr" (data/obs.py); credit_tpu's tuple
# leaves it out, so its load_dataset cannot build an "HRRR" source
CLOCKED_TYPES = ("zarr", "arco_era5", "wb2_era5", "tisr", "goes", "hrrr",
                 "HRRR", "mrms")


def build_source_dataset(dtype: str, schema, src: dict, dconf: dict,
                         name: str, grid, history_len: int):
    """Instantiate one source dataset (reference: gen_2 _SOURCE_REGISTRY
    routing, multi_source.py:99 route_to_dataset_class)."""
    from credit_torch.data import era5 as _era5  # noqa: F401 (registration)
    from credit_torch.data import obs as _obs  # noqa: F401
    from credit_torch.data import tisr as _tisr  # noqa: F401

    cls = registry.get("dataset", dtype)
    if dtype in CLOCKED_TYPES:
        forecast_len = int(dconf.get("forecast_len", 1)) or 1
        kwargs = dict(source_name=name, history_len=history_len,
                      forecast_len=forecast_len)
        if dtype == "tisr":
            kwargs["grid"] = grid
        return cls(schema, src, dconf, **kwargs)
    return cls(schema, path=src["path"], history_len=history_len)


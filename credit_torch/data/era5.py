"""Cloud zarr dataset sources: ARCO-ERA5 / WeatherBench2 (+ generic zarr);
the port's copy of credit_tpu/data/era5.py.

A re-design of the reference's streaming cloud datasets (reference:
credit/datasets/gen_2/era5.py:56 ARCOERA5Dataset, gen_2/local.py
LocalDataset's zarr branch, gen_2/base_dataset.py:311 _register_fields /
:374 __getitem__ / :697 _build_timestamps): instead of per-item torch
Dataset dict trees, samples are assembled directly into the flat
channels-last float32 numpy arrays the train step consumes, on a
CF-calendar TimeClock master clock. Store access goes through the port's
zarr-v2 reader (credit_torch/data/zarrlite.py) + fsspec/gcsfs, so the same
class reads the public buckets and local stores.

Config (same shape as the reference's):
    data:
      source:
        MyERA5:
          dataset_type: arco_era5 | wb2_era5 | zarr
          store_path: <override; defaults to the public bucket>
          level_coord: level            # name of the vertical coordinate
          levels: [500., 850., 1000.]   # coordinate VALUES to select
          calendar: standard
          variables: {prognostic: {...}, dynamic_forcing: {...}, ...}
      start_datetime: "2018-01-01"
      end_datetime: "2018-12-31"
      timestep: "6h"
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional

import numpy as np

from credit_torch import registry
from credit_torch.data.channels import ChannelSchema
from credit_torch.data.timeclock import (TimeClock, normalize_calendar,
                                       parse_datetime, parse_timestep)
from credit_torch.data.zarrlite import ZarrGroup, open_group

logger = logging.getLogger(__name__)

ARCO_ERA5_PATH = ("gs://gcp-public-data-arco-era5/ar/"
                  "full_37-1h-0p25deg-chunk-1.zarr-v3")
WB2_ERA5_PATH = ("gs://weatherbench2/datasets/era5/"
                 "1959-2023_01_10-6h-64x32_equiangular_conservative.zarr")


def _decode_time_axis(group: ZarrGroup, name: str = "time"):
    """Store time coordinate -> (base datetime, unit timedelta, raw values).
    Parses CF 'X since Y' units on the store's own calendar."""
    arr = group[name]
    units = arr.attrs.get("units", "hours since 1900-01-01")
    cal = normalize_calendar(arr.attrs.get("calendar", "standard"))
    m = re.match(r"\s*(\w+)\s+since\s+(.+)", units)
    if not m:
        raise ValueError(f"cannot parse time units {units!r}")
    unit_map = {"hours": "h", "hour": "h", "days": "d", "day": "d",
                "minutes": "min", "minute": "min", "seconds": "s",
                "second": "s"}
    unit = parse_timestep("1" + unit_map[m.group(1).lower()])
    base = parse_datetime(m.group(2).strip().split(" UTC")[0], cal)
    vals = np.asarray(arr.read())
    return base, unit, vals, cal


from credit_torch.data.source_base import ClockedSource


class ZarrSourceDataset(ClockedSource):
    """One schema source backed by one zarr store on the master clock.

    Sample API matches SyntheticDataset/LocalDataset (input_at/target_at/
    forcing_at/sample/batch, integer indices on the clock), plus datetime
    addressing: init_times() lists valid init datetimes and time_of(idx)
    maps clock index -> datetime (the reference's metadata.input_datetime).
    """

    dataset_type = "zarr"

    def __init__(self, schema: ChannelSchema, src_conf: dict, data_conf: dict,
                 source_name: Optional[str] = None, history_len: int = 1,
                 forecast_len: int = 1):
        self.schema = schema
        self.source = source_name
        self.history_len = history_len
        store = src_conf.get("store_path") or self.default_store(src_conf)
        self.group = open_group(store)
        self.calendar = normalize_calendar(
            src_conf.get("calendar", data_conf.get("calendar", "standard")))
        self.clock = TimeClock(
            data_conf.get("start_datetime", "1979-01-01"),
            data_conf.get("end_datetime", "2022-12-31"),
            data_conf.get("timestep", "6h"), self.calendar,
            history_len=history_len, num_forecast_steps=forecast_len)

        # map the clock onto the store's time axis
        tname = src_conf.get("time_coord", "time")
        base, unit, vals, store_cal = _decode_time_axis(self.group, tname)
        if store_cal != self.calendar:
            raise ValueError(f"store calendar {store_cal} != configured "
                             f"{self.calendar}")
        t0_val = (self.clock.time_at(0) - base) / unit
        dt_val = self.clock.dt / unit
        self._t0 = int(np.searchsorted(vals, t0_val))
        if self._t0 >= len(vals) or vals[self._t0] != t0_val:
            raise ValueError(
                f"clock start {self.clock.time_at(0)} not on the store's "
                f"time axis (store spans {base + vals[0] * unit} .. "
                f"{base + vals[-1] * unit})")
        store_step = float(vals[1] - vals[0]) if len(vals) > 1 else float(dt_val)
        stride = float(dt_val) / store_step
        if abs(stride - round(stride)) > 1e-9 or stride < 1:
            raise ValueError(f"store timestep ({store_step} {unit}) does not "
                             f"divide the clock timestep ({dt_val} {unit})")
        self._stride = int(round(stride))
        need = self._t0 + (len(self.clock.all_times) - 1) * self._stride
        if need >= len(vals):
            raise ValueError(f"clock end exceeds the store's time axis "
                             f"({need} >= {len(vals)})")
        if vals[self._t0 + self._stride] - vals[self._t0] != dt_val:
            raise ValueError("store time axis is not uniform at the clock "
                             "timestep")

        # level selection: coordinate VALUES -> indices
        self.level_coord = src_conf.get("level_coord", "level")
        levels = src_conf.get("levels")
        self._lev_idx: Optional[np.ndarray] = None
        if levels and self.level_coord in self.group:
            coord = np.asarray(self.group[self.level_coord].read())
            idx = []
            for lv in levels:
                pos = np.nonzero(np.isclose(coord, float(lv)))[0]
                if pos.size == 0:
                    raise ValueError(f"level {lv} not in store levels "
                                     f"{coord.tolist()}")
                idx.append(int(pos[0]))
            self._lev_idx = np.asarray(idx)

        self._static_cache: Dict[str, np.ndarray] = {}
        # variable name mapping (schema base name -> store array name)
        self.rename = src_conf.get("rename", {}) or {}

    @staticmethod
    def default_store(src_conf: dict) -> str:
        raise ValueError("dataset_type zarr requires store_path")

    # ------------------------------------------------------------------
    def _store_t(self, t_idx: int) -> int:
        return self._t0 + t_idx * self._stride

    def _read_var(self, base_name: str, t_idx: int, is_static: bool
                  ) -> np.ndarray:
        """-> (lat, lon) for 2-D / (lat, lon, L) for 3-D variables."""
        name = self.rename.get(base_name, base_name)
        if name not in self.group:
            raise KeyError(f"variable {name!r} not in store")
        arr = self.group[name]
        if is_static:
            if base_name not in self._static_cache:
                a = arr.read()
                if a.ndim == 3:  # (time=1, lat, lon)
                    a = a[0]
                self._static_cache[base_name] = np.asarray(a, np.float32)
            return self._static_cache[base_name]
        st = self._store_t(t_idx)
        if arr.ndim == 4:  # (time, level, lat, lon)
            lev = (self._lev_idx if self._lev_idx is not None
                   else slice(None))
            block = arr.read((st, lev))        # (L, lat, lon)
            return np.moveaxis(block, 0, -1)   # (lat, lon, L)
        block = arr.read((st,))                # (lat, lon)
        return np.asarray(block)


@registry.register("dataset", "zarr")
class GenericZarrDataset(ZarrSourceDataset):
    dataset_type = "zarr"


@registry.register("dataset", "arco_era5")
class ARCOERA5Dataset(ZarrSourceDataset):
    """Google Cloud ARCO-ERA5 public store
    (reference: gen_2/era5.py:56; pressure- and model-level paths)."""

    dataset_type = "arco_era5"

    @staticmethod
    def default_store(src_conf: dict) -> str:
        return ARCO_ERA5_PATH


@registry.register("dataset", "wb2_era5")
class WB2ERA5Dataset(ZarrSourceDataset):
    """WeatherBench2 regridded ERA5 store (reference: the WB2 paths used in
    gen_2 configs; 6-hourly, equiangular grids)."""

    dataset_type = "wb2_era5"

    @staticmethod
    def default_store(src_conf: dict) -> str:
        return WB2_ERA5_PATH

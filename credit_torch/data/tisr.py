"""Computed TISR dataset source (no files — analytic solar forcing): the
port's copy of credit_tpu/data/tisr.py.

Reference: credit/datasets/gen_2/tisr.py TISRDataset — a dataset that
*computes* top-of-atmosphere incident solar radiation on the master clock
instead of reading a store. Here it produces the 'tisr' dynamic-forcing
channel as flat (lat, lon) fields via the in-repo analytic solar model
(credit_torch/physics/solar.py, Spencer-1971 + accumulation), calendar-aware:
day-of-year/hour come from the clock's CF calendar, so a noleap simulation
never sees a Feb-29 sun.
"""

from __future__ import annotations

import datetime as _dt
from typing import List, Optional

import numpy as np

from credit_torch import registry
from credit_torch.data.channels import ChannelSchema
from credit_torch.data.timeclock import CFDatetime, TimeClock
from credit_torch.physics.solar import tisr_accumulated


def _doy_hour(t) -> tuple:
    if isinstance(t, CFDatetime):
        return t.dayofyear(), t.hour_float()
    ts = np.datetime64(t, "s")
    year = ts.astype("datetime64[Y]")
    doy = int((ts.astype("datetime64[D]") - year.astype("datetime64[D]"))
              / np.timedelta64(1, "D")) + 1
    secs = int((ts - ts.astype("datetime64[D]").astype("datetime64[s]"))
               / np.timedelta64(1, "s"))
    return doy, secs / 3600.0


@registry.register("dataset", "tisr")
class TISRDataset:
    """Computed TISR on the clock; same sample API as the other sources."""

    dataset_type = "tisr"

    def __init__(self, schema: ChannelSchema, src_conf: dict, data_conf: dict,
                 source_name: Optional[str] = None, history_len: int = 1,
                 forecast_len: int = 1, grid=None):
        self.schema = schema
        self.source = source_name
        self.history_len = history_len
        if grid is None:
            raise ValueError("TISR source needs the grid (lat/lon degrees)")
        self.lat = np.asarray(grid.lat)
        self.lon = np.asarray(grid.lon)
        self.period_hours = float(src_conf.get(
            "period_hours", data_conf.get("lead_time_periods", 6)))
        self.tsi = float(src_conf.get("tsi", 1361.0))
        self.var = (src_conf.get("variables", {}).get("dynamic_forcing", {})
                    .get("vars_2D") or ["tisr"])[0]
        self.clock = TimeClock(
            data_conf.get("start_datetime", "1979-01-01"),
            data_conf.get("end_datetime", "2022-12-31"),
            data_conf.get("timestep", "6h"),
            src_conf.get("calendar", data_conf.get("calendar", "standard")),
            history_len=history_len, num_forecast_steps=forecast_len)

    def __len__(self):
        return len(self.clock.all_times)

    def init_times(self) -> List:
        return list(self.clock.init_times)

    def time_of(self, t_idx: int):
        return self.clock.time_at(t_idx)

    def _field(self, t_idx: int) -> np.ndarray:
        doy, hour = _doy_hour(self.clock.time_at(t_idx))
        when = _dt.datetime(2001, 1, 1) + _dt.timedelta(days=doy - 1,
                                                        hours=hour)
        return np.asarray(tisr_accumulated(
            self.lat, self.lon, when, self.period_hours,
            tsi=self.tsi), np.float32)

    def _stack(self, t_idx: int, entries) -> np.ndarray:
        cols = []
        for e in entries:
            if e.name != self.var:
                raise KeyError(f"TISR source only provides {self.var!r}, "
                               f"asked for {e.name!r}")
            cols.append(self._field(t_idx))
        return np.stack(cols, axis=-1).astype(np.float32)

    def input_at(self, t_idx: int) -> np.ndarray:
        frames = [self._stack(t_idx - k, [e for e in self.schema.input_entries
                                          if e.source == self.source])
                  for k in reversed(range(self.history_len))]
        return np.stack(frames, axis=0)

    def target_at(self, t_idx: int) -> np.ndarray:
        # forcing-only source: no targets
        return np.zeros((1, len(self.lat), len(self.lon), 0), np.float32)

    def forcing_at(self, t_idx: int) -> Optional[np.ndarray]:
        return self.input_at(t_idx)[-1:]

    def sample(self, t_idx: int, n_steps: int = 1):
        return {"x": self.input_at(t_idx),
                "y": np.concatenate([self.target_at(t_idx + 1 + s)
                                     for s in range(n_steps)], axis=0),
                "forcing": np.concatenate([self.forcing_at(t_idx + 1 + s)
                                           for s in range(n_steps)], axis=0)}

    def batch(self, t_indices, n_steps: int = 1):
        samples = [self.sample(int(t), n_steps) for t in t_indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

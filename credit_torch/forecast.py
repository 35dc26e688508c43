"""Forecast initialization scheduling (the port's own copy of
credit_tpu/forecast.py).

Re-implements the reference's init-time generation (reference:
credit/forecast.py:7 load_forecasts / :39 generate_forecasts and the gen2
batch_init_times, credit/trainers/rollout_utils.py:34): expands a predict
config into the list of initialization datetimes to roll out.
"""

from __future__ import annotations

import datetime as dt
from typing import List


def generate_forecasts(pconf: dict) -> List[dt.datetime]:
    """predict.forecasts:
      type: custom
      start_year/month/day, start_hours: [0, 12], duration (days spanned),
      days (forecast length is separate).
    Returns one datetime per (day in duration) x start_hour."""
    f = pconf.get("forecasts", {}) or {}
    if isinstance(f, list):  # explicit list of [iso strings]
        return [dt.datetime.fromisoformat(s) for s in f]
    start = dt.datetime(int(f.get("start_year", 2020)),
                        int(f.get("start_month", 1)),
                        int(f.get("start_day", 1)))
    hours = f.get("start_hours", [0]) or [0]
    duration = int(f.get("duration", 1))
    out = []
    for d in range(duration):
        day = start + dt.timedelta(days=d)
        for h in hours:
            out.append(day + dt.timedelta(hours=int(h)))
    return out


def strided_for_rank(inits: List[dt.datetime], rank: int, world: int) -> List[dt.datetime]:
    """Rank-strided init-time assignment (reference:
    rollout_to_netcdf.py:266 — one init subset per rank)."""
    return inits[rank::max(world, 1)]

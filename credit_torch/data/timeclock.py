"""CF-calendar master clock for datasets: the port's copy of
credit_tpu/data/timeclock.py.

Re-implements the reference's timestamp machinery
(reference: credit/datasets/gen_2/base_dataset.py:697 _build_timestamps,
gen_2/_utils.py:48 normalize_calendar / :73 to_calendar /
:115 build_time_index) without cftime/pandas-cftime, which this environment
lacks: standard-family calendars ride numpy datetime64[ns]; the non-standard
CF calendars (noleap/365_day, all_leap/366_day, 360_day) use an explicit
(day-number, seconds) representation with calendar-correct arithmetic — a
360_day clock steps 30-day months and a noleap clock never lands on Feb 29.

All datasets share one clock: init times are DATETIMES, not integer file
indices, and multi-source composition aligns per-source clocks by datetime.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np

STANDARD = {"standard", "gregorian", "proleptic_gregorian", None}
_ALIAS = {
    "365_day": "noleap", "noleap": "noleap",
    "366_day": "all_leap", "all_leap": "all_leap",
    "360_day": "360_day",
    "standard": "standard", "gregorian": "standard",
    "proleptic_gregorian": "standard",
}

_DAYS_PER_MONTH = {
    "noleap": [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
    "all_leap": [31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
    "360_day": [30] * 12,
}


def normalize_calendar(calendar) -> str:
    if calendar is None:
        return "standard"
    c = str(calendar).lower()
    if c not in _ALIAS:
        raise ValueError(f"unknown CF calendar {calendar!r}; "
                         f"supported: {sorted(_ALIAS)}")
    return _ALIAS[c]


def parse_timestep(freq) -> np.timedelta64:
    """'6h' / '1D' / '30min' / numeric hours -> timedelta64[s]."""
    if isinstance(freq, (int, float)):
        return np.timedelta64(int(freq * 3600), "s")
    m = re.fullmatch(r"\s*(\d+)\s*(h|hr|hour|hours|d|day|days|min|minutes|m|s|sec|seconds)\s*",
                     str(freq), re.IGNORECASE)
    if not m:
        raise ValueError(f"cannot parse timestep {freq!r}")
    n = int(m.group(1))
    unit = m.group(2).lower()
    scale = {"h": 3600, "hr": 3600, "hour": 3600, "hours": 3600,
             "d": 86400, "day": 86400, "days": 86400,
             "min": 60, "minutes": 60, "m": 60,
             "s": 1, "sec": 1, "seconds": 1}[unit]
    return np.timedelta64(n * scale, "s")


@dataclass(frozen=True, order=True)
class CFDatetime:
    """A datetime on a non-standard CF calendar (noleap/all_leap/360_day).

    Stored as (year, month, day, second-of-day); ordering is chronological
    within one calendar. Hashable so clocks can be dict keys."""
    year: int
    month: int
    day: int
    second: int = 0
    calendar: str = "noleap"

    def __post_init__(self):
        dpm = _DAYS_PER_MONTH[self.calendar]
        if not (1 <= self.month <= 12 and 1 <= self.day <= dpm[self.month - 1]):
            raise ValueError(f"invalid {self.calendar} date "
                             f"{self.year}-{self.month:02d}-{self.day:02d}")

    # -- calendar arithmetic ------------------------------------------------
    def _days_in_year(self) -> int:
        return sum(_DAYS_PER_MONTH[self.calendar])

    def to_ordinal(self) -> Tuple[int, int]:
        """(days since year 0, second of day) on this calendar."""
        dpm = _DAYS_PER_MONTH[self.calendar]
        days = self.year * self._days_in_year() + sum(dpm[:self.month - 1]) \
            + (self.day - 1)
        return days, self.second

    @classmethod
    def from_ordinal(cls, days: int, second: int, calendar: str) -> "CFDatetime":
        diy = sum(_DAYS_PER_MONTH[calendar])
        year, doy = divmod(days, diy)
        month = 1
        for dpm in _DAYS_PER_MONTH[calendar]:
            if doy < dpm:
                break
            doy -= dpm
            month += 1
        return cls(year, month, doy + 1, second, calendar)

    def __add__(self, delta: np.timedelta64) -> "CFDatetime":
        secs = int(delta / np.timedelta64(1, "s"))
        days, sod = self.to_ordinal()
        total = sod + secs
        dd, sod = divmod(total, 86400)
        return CFDatetime.from_ordinal(days + dd, sod, self.calendar)

    def __sub__(self, other):
        if isinstance(other, CFDatetime):
            d0, s0 = self.to_ordinal()
            d1, s1 = other.to_ordinal()
            return np.timedelta64((d0 - d1) * 86400 + (s0 - s1), "s")
        return self + (-other)

    def __str__(self):
        h, rem = divmod(self.second, 3600)
        m, s = divmod(rem, 60)
        return (f"{self.year:04d}-{self.month:02d}-{self.day:02d}"
                f"T{h:02d}:{m:02d}:{s:02d}")

    # day-of-year (1-based) for solar forcing on model calendars
    def dayofyear(self) -> int:
        dpm = _DAYS_PER_MONTH[self.calendar]
        return sum(dpm[:self.month - 1]) + self.day

    def hour_float(self) -> float:
        return self.second / 3600.0


Datetime = Union[np.datetime64, CFDatetime]


def parse_datetime(value, calendar: str = "standard") -> Datetime:
    """ISO string / datetime64 / CFDatetime -> clock datetime on `calendar`."""
    cal = normalize_calendar(calendar)
    if isinstance(value, CFDatetime):
        if value.calendar != cal:
            raise ValueError(f"calendar mismatch: {value.calendar} vs {cal}")
        return value
    if cal == "standard":
        return np.datetime64(value, "s")
    # parse the ISO fields ourselves, then validate against the calendar
    m = re.fullmatch(
        r"(\d{1,4})-(\d{2})-(\d{2})(?:[T ](\d{2}):(\d{2})(?::(\d{2}))?)?",
        str(value).strip())
    if not m:
        raise ValueError(f"cannot parse datetime {value!r}")
    y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    sec = (int(m.group(4) or 0) * 3600 + int(m.group(5) or 0) * 60
           + int(m.group(6) or 0))
    return CFDatetime(y, mo, d, sec, cal)


def build_time_index(start, end, timestep, calendar: str = "standard"):
    """Inclusive [start, end] range at `timestep` on `calendar`
    (reference: _utils.py:115 build_time_index)."""
    cal = normalize_calendar(calendar)
    dt = parse_timestep(timestep)
    t0, t1 = parse_datetime(start, cal), parse_datetime(end, cal)
    if cal == "standard":
        n = int((t1 - t0) / dt) + 1
        return t0 + np.arange(max(n, 0)) * dt
    out: List[CFDatetime] = []
    t = t0
    while not (t - t1) > np.timedelta64(0, "s"):
        out.append(t)
        t = t + dt
    return np.asarray(out, dtype=object)


class TimeClock:
    """Master clock: valid INIT times given history/forecast margins
    (reference: base_dataset.py:697 — start pushed forward by
    (history_len-1)*dt, end pulled back by num_forecast_steps*dt, margin
    arithmetic done ON the target calendar)."""

    def __init__(self, start, end, timestep="6h", calendar: str = "standard",
                 history_len: int = 1, num_forecast_steps: int = 1):
        self.calendar = normalize_calendar(calendar)
        self.dt = parse_timestep(timestep)
        self.start = parse_datetime(start, self.calendar)
        self.end = parse_datetime(end, self.calendar)
        first = self.start + (history_len - 1) * self.dt
        last = self.end - num_forecast_steps * self.dt
        self.init_times = build_time_index(first, last, self.dt, self.calendar)
        # the full clock (for mapping init -> file/array offsets)
        self.all_times = build_time_index(self.start, self.end, self.dt,
                                          self.calendar)
        self._pos = {self._key(t): i for i, t in enumerate(self.all_times)}
        self.history_len = history_len
        self.num_forecast_steps = num_forecast_steps

    @staticmethod
    def _key(t):
        return str(t)

    def __len__(self):
        return len(self.init_times)

    def index_of(self, t) -> int:
        """Position of datetime t on the full clock."""
        k = self._key(parse_datetime(t, self.calendar))
        if k not in self._pos:
            raise KeyError(f"{t} not on the clock "
                           f"({self.start}..{self.end} @ {self.dt})")
        return self._pos[k]

    def time_at(self, idx: int):
        return self.all_times[idx]

    def window(self, init_time, n_steps: int) -> Sequence:
        """history_len inputs ending at init_time plus n_steps targets."""
        i = self.index_of(init_time)
        return self.all_times[i - self.history_len + 1: i + n_steps + 1]

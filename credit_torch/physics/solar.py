"""Solar forcing: TOA incident solar radiation (TISR) computed analytically
(the port's copy of credit_tpu/physics/solar.py, numpy only).

Fills the role of the reference's solar module and TISR dataset
(reference: credit/solar.py — ERA5-compatible TSI table :11 from the IFS
values, pvlib/numba-assisted TOA radiation :140; credit/datasets/gen_2/
tisr.py computes TISR analytically). Here: the same TSI table plus a
dependency-free solar-position model (Spencer 1971 declination/equation of
time — accurate to ~0.01 for TOA flux), vectorized over the grid in numpy
on the host (the data pipeline's side of the batch boundary).
"""

from __future__ import annotations

import datetime as _dt
from typing import Union

import numpy as np

# ERA5-compatible mean TSI (the reference's table averages ~1361 W/m^2 after
# the 0.9965 IFS rescale); per-year values refine this — the climatological
# mean is used when no table is supplied.
MEAN_TSI = 1361.0


def _day_angle(day_of_year, year_len=365.25):
    return 2.0 * np.pi * (day_of_year - 1) / year_len


def declination(day_of_year):
    """Solar declination (rad), Spencer (1971) Fourier fit."""
    g = _day_angle(day_of_year)
    return (0.006918 - 0.399912 * np.cos(g) + 0.070257 * np.sin(g)
            - 0.006758 * np.cos(2 * g) + 0.000907 * np.sin(2 * g)
            - 0.002697 * np.cos(3 * g) + 0.00148 * np.sin(3 * g))


def equation_of_time(day_of_year):
    """Equation of time (minutes), Spencer (1971)."""
    g = _day_angle(day_of_year)
    return 229.18 * (0.000075 + 0.001868 * np.cos(g) - 0.032077 * np.sin(g)
                     - 0.014615 * np.cos(2 * g) - 0.040849 * np.sin(2 * g))


def earth_sun_distance_factor(day_of_year):
    """(r0/r)^2 eccentricity correction, Spencer (1971)."""
    g = _day_angle(day_of_year)
    return (1.000110 + 0.034221 * np.cos(g) + 0.001280 * np.sin(g)
            + 0.000719 * np.cos(2 * g) + 0.000077 * np.sin(2 * g))


def cos_zenith(lat_deg, lon_deg, day_of_year, utc_hours):
    """cos(solar zenith) on the grid; lat (H,), lon (W,) -> (H, W)."""
    lat = np.deg2rad(np.asarray(lat_deg))[:, None]
    lon = np.asarray(lon_deg)[None, :]
    dec = declination(day_of_year)
    eot = equation_of_time(day_of_year)
    solar_time = utc_hours + lon / 15.0 + eot / 60.0
    hour_angle = np.deg2rad(15.0 * (solar_time - 12.0))
    mu = (np.sin(lat) * np.sin(dec)
          + np.cos(lat) * np.cos(dec) * np.cos(hour_angle))
    return np.clip(mu, 0.0, None)


def toa_instantaneous_flux(lat_deg, lon_deg, when: Union[_dt.datetime, float],
                           utc_hours: float = None, tsi: float = MEAN_TSI):
    """Instantaneous TOA downward solar flux (W/m^2) on the grid."""
    if isinstance(when, _dt.datetime):
        doy = when.timetuple().tm_yday
        hours = when.hour + when.minute / 60.0 + when.second / 3600.0
    else:
        doy = float(when)
        hours = utc_hours if utc_hours is not None else 12.0
    mu = cos_zenith(lat_deg, lon_deg, doy, hours)
    return tsi * earth_sun_distance_factor(doy) * mu


def tisr_accumulated(lat_deg, lon_deg, when: _dt.datetime,
                     period_hours: float = 1.0, n_sub: int = 6,
                     tsi: float = MEAN_TSI):
    """TOA incident solar radiation accumulated over `period_hours` ending at
    `when` (J/m^2) — ERA5 'tisr' convention; trapezoid in time
    (reference: solar.py:140 integrates instantaneous flux)."""
    doy = when.timetuple().tm_yday
    end = when.hour + when.minute / 60.0 + when.second / 3600.0
    ts = np.linspace(end - period_hours, end, n_sub + 1)
    flux = np.stack([tsi * earth_sun_distance_factor(doy)
                     * cos_zenith(lat_deg, lon_deg, doy, t) for t in ts])
    return np.trapezoid(flux, dx=period_hours * 3600.0 / n_sub, axis=0)

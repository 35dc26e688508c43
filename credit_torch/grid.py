"""Grid metadata: lat/lon/level coordinates, quadrature weights, hybrid coefs
(port of credit_tpu/grid.py, a copy of its numpy code).

Static (host-side numpy) grid description consumed by the physics integrals
of the conservation fixers (reference: credit/physics_core.py) and, as the
port grows, by latitude-weighted losses and metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

EARTH_RADIUS_M = 6371000.0  # matches reference credit/physics_constants.py
GRAVITY = 9.80665
RVGAS = 461.5
RDGAS = 287.05
LH_WATER = 2.501e6
CP_DRY = 1004.64
CP_VAPOR = 1810.0


@dataclasses.dataclass(frozen=True)
class Grid:
    """A global (or regional) lat-lon(-level) grid.

    lat: degrees north, shape (nlat,). May be descending (ERA5 style, 90..-90)
         or ascending; stored as given.
    lon: degrees east, shape (nlon,).
    levels: vertical coordinate values (model or pressure levels), optional.
    ak, bk: hybrid sigma-pressure interface coefficients (nlev+1,), optional,
            such that p_interface = ak + bk * surface_pressure
            (reference: credit/physics_core.py:36 ModelLevelPressures).
    """

    lat: np.ndarray
    lon: np.ndarray
    levels: Optional[np.ndarray] = None
    ak: Optional[np.ndarray] = None
    bk: Optional[np.ndarray] = None

    @property
    def nlat(self) -> int:
        return int(self.lat.shape[0])

    @property
    def nlon(self) -> int:
        return int(self.lon.shape[0])

    @property
    def nlev(self) -> int:
        return 0 if self.levels is None else int(self.levels.shape[0])

    @property
    def shape(self):
        return (self.nlat, self.nlon)

    def coslat_weights(self, normalize: bool = True) -> np.ndarray:
        """cos(lat) latitude weights, shape (nlat,).

        Matches reference loss weighting (credit/losses/weighted_loss.py uses
        cos-lat weights normalized to mean 1).
        """
        w = np.cos(np.deg2rad(self.lat))
        w = np.clip(w, 0.0, None)
        if normalize:
            w = w / w.mean()
        return w.astype(np.float64)

    def cell_area(self) -> np.ndarray:
        """Spherical cell areas (m^2), shape (nlat, nlon).

        Cells are bounded by midpoints between grid lines; pole rows get a cap
        from the last midpoint to the pole. Used by global conservation
        integrals (reference: credit/physics_core.py area-weighted sums).
        """
        lat = np.deg2rad(self.lat.astype(np.float64))
        order = np.argsort(lat)
        lat_sorted = lat[order]
        edges = np.empty(lat_sorted.shape[0] + 1)
        edges[1:-1] = 0.5 * (lat_sorted[:-1] + lat_sorted[1:])
        edges[0] = max(-np.pi / 2, lat_sorted[0] - (edges[1] - lat_sorted[0]))
        edges[-1] = min(np.pi / 2, lat_sorted[-1] + (lat_sorted[-1] - edges[-2]))
        band = np.sin(edges[1:]) - np.sin(edges[:-1])  # per sorted-lat band
        band_unsorted = np.empty_like(band)
        band_unsorted[order] = band
        dlon = 2 * np.pi / self.nlon
        area = EARTH_RADIUS_M**2 * dlon * band_unsorted
        return np.broadcast_to(area[:, None], (self.nlat, self.nlon)).copy()

    def pressure_interfaces(self, sp):
        """p_iface = ak + bk * sp; sp a tensor (..., nlat, nlon) -> (..., nlev+1,
        nlat, nlon), in f32 on sp's device (the coefficients as the reference
        takes them, float64 cast to f32)."""
        ak = torch.as_tensor(self.ak, dtype=torch.float32, device=sp.device)
        bk = torch.as_tensor(self.bk, dtype=torch.float32, device=sp.device)
        return ak[..., :, None, None] + bk[..., :, None, None] * sp[..., None, :, :]

    @staticmethod
    def regular(nlat: int, nlon: int, levels: Optional[Sequence[float]] = None,
                ak=None, bk=None, descending_lat: bool = True) -> "Grid":
        """Regular grid including poles (e.g. 181 x 360 for 1 degree)."""
        lat = np.linspace(90.0, -90.0, nlat) if descending_lat else np.linspace(-90.0, 90.0, nlat)
        lon = np.linspace(0.0, 360.0, nlon, endpoint=False)
        return Grid(
            lat=lat, lon=lon,
            levels=None if levels is None else np.asarray(levels, dtype=np.float64),
            ak=None if ak is None else np.asarray(ak, dtype=np.float64),
            bk=None if bk is None else np.asarray(bk, dtype=np.float64),
        )


def grid_from_conf(conf: dict) -> Grid:
    """Build a Grid from a gen2-style config.

    Dims come from the model section when present; data-only configs
    (no `model`, e.g. the reference's preprocessing configs) instead carry
    a per-source `resolution: "WxH"` field (reference:
    config/gen_2/examples/weatherbench2_era5_wxformer.yml)."""
    sources = conf.get("data", {}).get("source") or {}
    m = conf.get("model")
    if m is not None:
        nlat = int(m["image_height"])
        nlon = int(m["image_width"])
    else:
        res = next((s["resolution"] for s in sources.values()
                    if s.get("resolution")), None)
        if res is None:
            raise ValueError(
                "config has no 'model' section and no data source declares a "
                "'resolution: \"WxH\"' — cannot determine grid dimensions")
        w, h = str(res).lower().split("x")
        nlat, nlon = int(h), int(w)
    levels = None
    for src in sources.values():
        if "levels" in src:
            levels = src["levels"]
            break
    return Grid.regular(nlat, nlon, levels=levels)

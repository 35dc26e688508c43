"""Map projections for observational grids: GOES fixed-grid, HRRR Lambert
(the port's copy of credit_tpu/data/projection.py).

The reference ships pre-computed 2-D lat/lon grids for the GOES imager
projection and HRRR's Lambert-conformal grid (reference:
credit/datasets/gen_2/goes.py:388 — the latlon2d_dir files derived from the
GOES-R PUG fixed-grid equations; gen_2/hrrr.py:25 — HRRR's native Lambert
grid). We compute them directly from the projection parameters so readers
work without sidecar files, and expose the same 2-D coordinate contract to
the regrid preblock.

All functions are pure NumPy (host-side, once per dataset).
"""

from __future__ import annotations

import numpy as np

# GOES-R series defaults (GRS80 ellipsoid + geostationary altitude) — the
# values carried in every ABI granule's goes_imager_projection variable
GOES_SEMI_MAJOR = 6378137.0          # m
GOES_SEMI_MINOR = 6356752.31414      # m
GOES_HEIGHT = 35786023.0             # perspective point height above ellipsoid
GOES_LON_EAST = -75.0                # GOES-16/19 operational longitude
GOES_LON_WEST = -137.0               # GOES-17/18 operational longitude

# HRRR CONUS grid (NCEP grid 227 family): tangent Lambert conformal on a
# sphere (reference: gen_2/hrrr.py module docstring — y/x are HRRR's native
# Lambert-conformal projection grid)
HRRR_PARAMS = dict(
    lat_1=38.5, lat_2=38.5, lat_0=38.5, lon_0=-97.5,
    radius=6371229.0, dx=3000.0, dy=3000.0,
    nx=1799, ny=1059, ll_lat=21.138123, ll_lon=-122.719528)


def goes_fixed_grid_to_latlon(x, y, lon_origin: float = GOES_LON_EAST,
                              h: float = GOES_HEIGHT,
                              r_eq: float = GOES_SEMI_MAJOR,
                              r_pol: float = GOES_SEMI_MINOR):
    """ABI fixed-grid scan angles (radians) -> geodetic lat/lon (degrees).

    Implements the GOES-R PUG's inverse navigation equations
    (the math behind the reference's latlon2d_dir grids, goes.py:388).
    `x` (E/W) and `y` (N/S) broadcast: pass 1-D coords to get 2-D grids.
    Off-disk pixels come back NaN.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.ndim == 1 and y.ndim == 1:
        x, y = np.meshgrid(x, y)  # (ny, nx)
    H = h + r_eq  # satellite distance from Earth's center
    sin_x, cos_x = np.sin(x), np.cos(x)
    sin_y, cos_y = np.sin(y), np.cos(y)
    rr = (r_eq / r_pol) ** 2
    a = sin_x**2 + cos_x**2 * (cos_y**2 + rr * sin_y**2)
    b = -2.0 * H * cos_x * cos_y
    c = H**2 - r_eq**2
    disc = b**2 - 4.0 * a * c
    with np.errstate(invalid="ignore"):
        r_s = (-b - np.sqrt(disc)) / (2.0 * a)  # NaN off-disk (disc < 0)
        s_x = r_s * cos_x * cos_y
        s_y = -r_s * sin_x
        s_z = r_s * cos_x * sin_y
        lat = np.arctan(rr * s_z / np.sqrt((H - s_x) ** 2 + s_y**2))
        lon = np.radians(lon_origin) - np.arctan(s_y / (H - s_x))
    return np.degrees(lat), np.degrees(lon)


def _lcc_consts(p: dict):
    lat1, lat2 = np.radians(p["lat_1"]), np.radians(p["lat_2"])
    if abs(p["lat_1"] - p["lat_2"]) < 1e-9:
        n = np.sin(lat1)  # tangent cone
    else:
        n = (np.log(np.cos(lat1) / np.cos(lat2))
             / np.log(np.tan(np.pi / 4 + lat2 / 2)
                      / np.tan(np.pi / 4 + lat1 / 2)))
    F = np.cos(lat1) * np.tan(np.pi / 4 + lat1 / 2) ** n / n
    rho0 = (p["radius"] * F
            / np.tan(np.pi / 4 + np.radians(p["lat_0"]) / 2) ** n)
    return n, F, rho0


def lambert_forward(lat, lon, params: dict = HRRR_PARAMS):
    """Geodetic degrees -> Lambert-conformal (x, y) meters (Snyder 15-1/2)."""
    p = params
    n, F, rho0 = _lcc_consts(p)
    lat, lon = np.radians(np.asarray(lat)), np.radians(np.asarray(lon))
    rho = p["radius"] * F / np.tan(np.pi / 4 + lat / 2) ** n
    th = n * (lon - np.radians(p["lon_0"]))
    return rho * np.sin(th), rho0 - rho * np.cos(th)


def lambert_inverse(x, y, params: dict = HRRR_PARAMS):
    """Lambert-conformal (x, y) meters -> geodetic lat/lon degrees."""
    p = params
    n, F, rho0 = _lcc_consts(p)
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    rho = np.sign(n) * np.sqrt(x**2 + (rho0 - y) ** 2)
    th = np.arctan2(x, rho0 - y)
    lat = 2.0 * np.arctan((p["radius"] * F / rho) ** (1.0 / n)) - np.pi / 2
    lon = np.radians(p["lon_0"]) + th / n
    return np.degrees(lat), np.degrees(lon)


def lambert_grid_latlon(params: dict = HRRR_PARAMS):
    """2-D (lat, lon) grids for a Lambert grid anchored at its lower-left
    corner (HRRR's native layout; reference gen_2/hrrr.py:770 uses the
    granule's own latitude/longitude arrays — this reproduces them)."""
    p = params
    x0, y0 = lambert_forward(p["ll_lat"], p["ll_lon"], p)
    xs = x0 + np.arange(p["nx"]) * p["dx"]
    ys = y0 + np.arange(p["ny"]) * p["dy"]
    xg, yg = np.meshgrid(xs, ys)
    return lambert_inverse(xg, yg, p)


def haversine_nearest(lat2d: np.ndarray, lon2d: np.ndarray,
                      lat: float, lon: float):
    """(i, j) of the grid point nearest a target, great-circle distance
    (reference: goes.py:112 _find_nearest_latlon)."""
    la, lo = np.radians(lat2d), np.radians(lon2d)
    ta, to = np.radians(lat), np.radians(lon)
    d = (np.sin((la - ta) / 2) ** 2
         + np.cos(la) * np.cos(ta) * np.sin((lo - to) / 2) ** 2)
    d = np.where(np.isfinite(d), d, np.inf)
    i, j = np.unravel_index(np.argmin(d), d.shape)
    return int(i), int(j)


def extent_slices(lat2d: np.ndarray, lon2d: np.ndarray, extent):
    """(row_slice, col_slice) cropping a curvilinear grid to an extent.

    extent: [lon_min, lon_max, lat_min, lat_max], or {'nw': [lat, lon],
    'se': [lat, lon]} for explicit corners (reference: goes.py:142
    _build_spatial_slices — two nearest-neighbour corner lookups).
    Assumes rows ordered north->south OR south->north; slices are
    normalized to increasing order.
    """
    if extent is None:
        return slice(None), slice(None)
    if isinstance(extent, dict):
        (lat_nw, lon_nw), (lat_se, lon_se) = extent["nw"], extent["se"]
    else:
        lon_min, lon_max, lat_min, lat_max = extent
        lat_nw, lon_nw, lat_se, lon_se = lat_max, lon_min, lat_min, lon_max
    i_nw, j_nw = haversine_nearest(lat2d, lon2d, lat_nw, lon_nw)
    i_se, j_se = haversine_nearest(lat2d, lon2d, lat_se, lon_se)
    i0, i1 = sorted((i_nw, i_se))
    j0, j1 = sorted((j_nw, j_se))
    return slice(i0, i1 + 1), slice(j0, j1 + 1)

"""Forecast visualization helpers: unit conversions, display ranges,
colormap policy (port of credit_tpu/visualization.py, a copy of its numpy
code; matplotlib is only the caller's, through the axes draw_field takes).

Behavioral equivalent of the reference's plotting stack
(reference: credit/animation.py:22-56 unit converters,
credit/visualization_tools.py:95-180 range/colormap pickers) without the
cartopy dependency — map drawing is plain lat-lon imshow (cartopy
projections are a rendering nicety, not framework function; hook
`get_projection` up when cartopy is installed).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# unit conversions (reference animation.py:22-56)


def kgkg_to_gkg(q):
    """Specific humidity kg/kg -> g/kg."""
    return q * 1000.0


def k_to_c(temperature):
    """Kelvin -> Celsius."""
    return temperature - 273.15


def k_to_f(temperature):
    """Kelvin -> Fahrenheit."""
    return (temperature - 273.15) * 9.0 / 5.0 + 32.0


def gp_to_height_dam(gp):
    """Geopotential (m^2/s^2) -> geopotential height in decameters."""
    return gp / 9.80665 / 10.0


def pa_to_hpa(pressure):
    """Pascals -> hectopascals."""
    return pressure / 100.0


UNIT_CONVERSIONS: Dict[str, Tuple[Callable, str]] = {
    # variable prefix -> (converter, display units)
    "Q": (kgkg_to_gkg, "g/kg"),
    "T": (k_to_c, "degC"),
    "VAR_2T": (k_to_c, "degC"),
    "t2m": (k_to_c, "degC"),
    "Z": (gp_to_height_dam, "dam"),
    "SP": (pa_to_hpa, "hPa"),
    "MSL": (pa_to_hpa, "hPa"),
    "mslp": (pa_to_hpa, "hPa"),
}


def convert_for_display(name: str, arr: np.ndarray) -> Tuple[np.ndarray, str]:
    """Apply the conventional display conversion for variable `name`
    (longest-prefix match on the registry); returns (converted, units)."""
    base = name.split("_L")[0]
    best = None
    for key in UNIT_CONVERSIONS:
        if (base == key or base.startswith(key)) and (
                best is None or len(key) > len(best)):
            best = key
    if best is None:
        return arr, ""
    fn, units = UNIT_CONVERSIONS[best]
    return fn(np.asarray(arr, np.float64)), units


# ---------------------------------------------------------------------------
# display ranges (reference visualization_tools.py:107-180)


def variable_range(data: np.ndarray, method: str = "mean_std",
                   n_std: float = 3.0) -> Tuple[float, float]:
    """Display range for a field: 'mean_std' = mean +- n_std*std (the
    reference default, robust to outliers), 'minmax' = exact extremes."""
    data = np.asarray(data, np.float64)
    if method == "minmax":
        return float(np.nanmin(data)), float(np.nanmax(data))
    mu, sd = float(np.nanmean(data)), float(np.nanstd(data))
    return mu - n_std * sd, mu + n_std * sd


def round_range(vmin: float, vmax: float) -> Tuple[float, float]:
    """Round a display range outward to 2 significant digits
    (reference visualization_tools.py:107 get_variable_range_with_rounding)."""
    span = vmax - vmin
    if span <= 0 or not np.isfinite(span):
        return vmin, vmax
    mag = 10.0 ** (np.floor(np.log10(span)) - 1)
    return float(np.floor(vmin / mag) * mag), float(np.ceil(vmax / mag) * mag)


def colormap_extend(data_range: Tuple[float, float],
                    display_range: Tuple[float, float]) -> str:
    """matplotlib colorbar `extend` policy: arrowheads where data exceed
    the display range (reference visualization_tools.py:95)."""
    lo = data_range[0] < display_range[0]
    hi = data_range[1] > display_range[1]
    return {(False, False): "neither", (True, False): "min",
            (False, True): "max", (True, True): "both"}[(lo, hi)]


def pick_colormap(name: str) -> str:
    """Conventional colormap per variable family (diverging for signed
    fields like winds/anomalies, sequential otherwise)."""
    base = name.split("_L")[0].upper()
    if base.startswith(("U", "V", "W")) or base in ("D", "VO"):
        return "RdBu_r"
    if base.startswith("Q") or base in ("TCW", "TP", "RAIN", "PRECIP"):
        return "viridis"
    if base.startswith("T") or base in ("SKT",):
        return "turbo"
    return "RdBu_r"


def panel_grid(n: int) -> Tuple[int, int]:
    """(rows, cols) layout for n variable panels
    (reference visualization_tools.py:183 figure_panel_planner)."""
    if n <= 1:
        return 1, 1
    if n == 2:
        return 1, 2
    if n <= 4:
        return 2, 2
    if n <= 6:
        return 2, 3
    cols = int(np.ceil(np.sqrt(n)))
    return int(np.ceil(n / cols)), cols


def draw_field(ax, arr: np.ndarray, name: str,
               lats: Optional[np.ndarray] = None,
               lons: Optional[np.ndarray] = None, rounded: bool = True):
    """Render one lat-lon field on `ax` with the conventional conversion,
    range, and colormap; returns the image handle (caller adds colorbar
    with `extend=colormap_extend(...)`)."""
    conv, units = convert_for_display(name, arr)
    vmin, vmax = variable_range(conv)
    if rounded:
        vmin, vmax = round_range(vmin, vmax)
    extent = None
    if lats is not None and lons is not None:
        extent = (float(lons[0]), float(lons[-1]),
                  float(lats[-1]), float(lats[0]))
    im = ax.imshow(conv, aspect="auto", cmap=pick_colormap(name),
                   vmin=vmin, vmax=vmax, extent=extent)
    title = f"{name} [{units}]" if units else name
    ax.set_title(title)
    return im

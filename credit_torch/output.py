"""Forecast output: flat arrays -> Datasets -> per-step netCDF files (port of
credit_tpu/output.py, numpy only, on the port's utils/ncio.py: real xarray
where it is installed, else scipy's netCDF-3 writer).

Mirrors the reference writer contract (reference: credit/output.py —
load_metadata:25, make_xarray:89, save_netcdf_increment:174 writes
`<init>Z/pred_<init>Z_<FHR>.nc`), channels-last and schema-driven: 3-D
variables are reassembled from their per-level channels.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from credit_torch.data.channels import ChannelSchema
from credit_torch.grid import Grid
from credit_torch.metadata import variable_attrs
from credit_torch.utils.ncio import Dataset, Variable, open_dataset


def split_channels(flat: np.ndarray, schema: ChannelSchema) -> Dict[str, np.ndarray]:
    """(..., lat, lon, C_target) -> {var: (..., lat, lon) or (..., lev, lat, lon)}."""
    out: Dict[str, np.ndarray] = {}
    levels: Dict[str, list] = {}
    for e in schema.target_entries:
        base, sep, lev = e.name.rpartition("_L")
        if sep and lev.isdigit():
            levels.setdefault(base, []).append((int(lev), e.index))
        else:
            out[e.name] = flat[..., e.index]
    for base, idxs in levels.items():
        idxs.sort()
        chans = [i for _, i in idxs]
        # (..., lat, lon, L) -> (..., L, lat, lon)
        arr = flat[..., chans]
        out[base] = np.moveaxis(arr, -1, -3)
    return out


def make_xarray(flat: np.ndarray, schema: ChannelSchema, grid: Grid,
                init_time=None, lead_hours: Optional[float] = None):
    """flat: (T, lat, lon, C_target) -> Dataset on the grid coords (real
    xarray when installed, else the built-in scipy-netCDF3 stand-in)."""
    fields = split_channels(flat, schema)
    coords = {"lat": grid.lat, "lon": grid.lon,
              "time": np.arange(flat.shape[0], dtype=np.float64)}
    if grid.levels is not None:
        coords["level"] = grid.levels
    data_vars = {}
    for name, arr in fields.items():
        # CF attributes per variable (reference: credit/metadata/era5.yaml
        # applied by output.py when writing forecasts)
        va = variable_attrs(name)
        if arr.ndim == 4:  # (T, lev, lat, lon)
            data_vars[name] = Variable(("time", "level", "lat", "lon"), arr, va)
        else:  # (T, lat, lon)
            data_vars[name] = Variable(("time", "lat", "lon"), arr, va)
    attrs = {}
    if init_time is not None:
        attrs["initialization_time"] = str(init_time)
    if lead_hours is not None:
        attrs["lead_hours"] = float(lead_hours)
    return Dataset(data_vars, coords, attrs)


def save_netcdf_increment(flat: np.ndarray, schema: ChannelSchema, grid: Grid,
                          save_dir: str, init_label: str, forecast_hour: int,
                          init_time=None) -> str:
    """Write one forecast step: <save_dir>/<init_label>/pred_<init_label>_<FHR>.nc
    (same file naming scheme as the reference, credit/output.py:174)."""
    ds = make_xarray(flat, schema, grid, init_time, forecast_hour)
    out_dir = os.path.join(save_dir, init_label)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"pred_{init_label}_{forecast_hour:03d}.nc")
    ds.to_netcdf(path)
    return path


class TemplateWriter:
    """Template-based writer for regional/downscaling output.

    Regional (projected-grid) forecasts carry coordinate/projection
    metadata that is easiest to preserve by copying a template file and
    replacing the data variables (reference:
    credit/output_downscaling.py:81 OutputWriter — template netCDF, keep
    listed prognostic/diagnostic vars, stamp new time coords).
    """

    def __init__(self, template_path: str, out_vars, zstride: int = 1):
        self.out_vars = [v for v in (out_vars or [])]
        self.noop = not self.out_vars
        if self.noop:
            return
        t = open_dataset(template_path)
        names = (list(t.data_vars) if hasattr(t, "data_vars") else
                 list(t.keys()))
        self.var_meta = {}
        for name in names:
            if name in self.out_vars:
                v = t[name]
                self.var_meta[name] = (tuple(v.dims), dict(v.attrs))
        coords = t.coords
        self.coords = {k: np.asarray(coords[k]) for k in coords
                       if k != "time"}
        self.zstride = zstride

    def write(self, data: Dict[str, np.ndarray], newtime: dict,
              output_path: str) -> Optional[str]:
        """data: {var: array matching the template var's dims}; newtime:
        {"time": array, "units": str, "calendar": str}."""
        if self.noop:
            return None
        data_vars = {}
        for name, (dims, attrs) in self.var_meta.items():
            if name not in data:
                continue
            arr = np.asarray(data[name])
            if self.zstride != 1 and "z" in dims:
                arr = arr[:, ::self.zstride]
            data_vars[name] = Variable(dims, arr, attrs)
        coords = dict(self.coords)
        coords["time"] = np.asarray(newtime.get("time", [0.0]))
        ds = Dataset(data_vars, coords,
                     {"time_units": newtime.get("units", ""),
                      "time_calendar": newtime.get("calendar", "standard")})
        ds.to_netcdf(output_path)
        return output_path


def write_downscaling_outputs(datadict: Dict[str, Dict[str, np.ndarray]],
                              writers: Dict[str, "TemplateWriter"],
                              newtime: dict, output_dir: str,
                              datestamp: str, prefix: str = "") -> list:
    """Route per-dataset variable dicts to their template writers
    (reference: credit/output_downscaling.py:27 OutputWrangler.process —
    one `<prefix>.<dataset>.<datestamp>.nc` per source dataset)."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for dset, data in datadict.items():
        w = writers.get(dset)
        if w is None or w.noop:
            continue
        fname = ".".join(p for p in (prefix, dset, datestamp, "nc") if p)
        path = w.write(data, newtime, os.path.join(output_dir, fname))
        if path:
            written.append(path)
    return written

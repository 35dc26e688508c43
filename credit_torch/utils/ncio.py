"""Minimal self-contained netCDF IO: the port's copy of
credit_tpu/utils/ncio.py.

scipy's netcdf_file (netCDF-3 classic, universally readable) is the
portable writer. The small dataset/variable wrappers expose the xarray
attribute surface the rest of the framework uses (`ds[name].values`,
`.dims`, `.attrs`, `in`), and `open_dataset`/`Dataset.to_netcdf` use real
xarray where it is installed (with netCDF4/zarr).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

try:  # pragma: no cover - environment dependent
    import xarray as _xr

    # ignore inert stand-ins (a module registered under the name with
    # __file__ = "<stub ...>")
    if str(getattr(_xr, "__file__", "")).startswith("<stub"):
        _xr = None
except ImportError:
    _xr = None


class Variable:
    def __init__(self, dims: Tuple[str, ...], values: np.ndarray,
                 attrs: Optional[dict] = None):
        self.dims = tuple(dims)
        self.values = np.asarray(values)
        self.attrs = dict(attrs or {})

    @property
    def shape(self):
        return self.values.shape

    def __array__(self, dtype=None):
        return np.asarray(self.values, dtype=dtype)


class Dataset:
    """Dict-of-Variables with coords; minimal xarray.Dataset stand-in."""

    def __init__(self, data_vars: Mapping[str, Tuple[Sequence[str], np.ndarray]],
                 coords: Optional[Mapping[str, np.ndarray]] = None,
                 attrs: Optional[dict] = None):
        self.data_vars: Dict[str, Variable] = {
            k: v if isinstance(v, Variable) else Variable(v[0], v[1])
            for k, v in data_vars.items()
        }
        self.coords: Dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in (coords or {}).items()
        }
        self.attrs = dict(attrs or {})

    def __contains__(self, k):
        return k in self.data_vars or k in self.coords

    def __getitem__(self, k) -> Variable:
        if k in self.data_vars:
            return self.data_vars[k]
        if k in self.coords:
            return Variable((k,), self.coords[k])
        raise KeyError(k)

    def keys(self):
        return self.data_vars.keys()

    # ------------------------------------------------------------------
    def to_netcdf(self, path: str):
        if _xr is not None:
            ds = _xr.Dataset(
                {k: (v.dims, v.values, v.attrs) for k, v in self.data_vars.items()},
                coords=self.coords, attrs=self.attrs)
            ds.to_netcdf(path)
            return
        from scipy.io import netcdf_file

        with netcdf_file(path, "w", version=2) as f:
            dims: Dict[str, int] = {}
            for v in self.data_vars.values():
                for d, n in zip(v.dims, v.values.shape):
                    dims.setdefault(d, n)
            for c, arr in self.coords.items():
                dims.setdefault(c, len(np.atleast_1d(arr)))
            for d, n in dims.items():
                f.createDimension(d, n)
            for c, arr in self.coords.items():
                arr = np.atleast_1d(np.asarray(arr))
                var = f.createVariable(c, arr.dtype.newbyteorder(">")
                                       if arr.dtype.kind in "fiu" else arr.dtype, (c,))
                var[:] = arr
            for name, v in self.data_vars.items():
                arr = np.asarray(v.values)
                if arr.dtype == np.float64:
                    arr = arr.astype(np.float32)
                dims_v = v.dims
                if arr.ndim == 0:
                    # scalar container vars (e.g. GOES projection attrs):
                    # netCDF-3/scipy can't write true scalars — promote to a
                    # shared length-1 dim (readers only use the attrs)
                    arr = arr.reshape(1)
                    dims_v = ("scalar",)
                    if "scalar" not in dims:
                        dims["scalar"] = 1
                        f.createDimension("scalar", 1)
                var = f.createVariable(name, arr.dtype, dims_v)
                var[:] = arr
                for ak, av in v.attrs.items():
                    setattr(var, ak, av)
            for ak, av in self.attrs.items():
                setattr(f, ak, str(av))


def open_dataset(path: str) -> Any:
    """Open netCDF via xarray when available, else scipy netCDF-3 reader."""
    if _xr is not None:
        return _xr.open_dataset(path)
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        coords = {}
        data_vars = {}
        dim_names = set(f.dimensions.keys())
        def _dec(v):
            return v.decode() if isinstance(v, bytes) else v

        for name, var in f.variables.items():
            vals = np.asarray(var.getValue() if var.dimensions == ()
                              else var[:])
            if name in dim_names and var.dimensions == (name,):
                coords[name] = vals
            else:
                attrs = {k: _dec(v) for k, v in var._attributes.items()}
                data_vars[name] = Variable(var.dimensions, vals, attrs)
        attrs = {k: _dec(v) for k, v in f._attributes.items()}
    return Dataset(data_vars, coords, attrs)

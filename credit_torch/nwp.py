"""Realtime NWP ingest: a GFS/GEFS analysis -> the model's initial
conditions (port of credit_tpu/nwp.py).

CREDIT's realtime plumbing (credit/nwp.py:27 build_GFS_init: GDAS GRIB,
regridded to the model grid and interpolated to its levels;
credit/gefs.py:14 download_gefs_run and the member assembly) as credit_tpu
re-designed it:

- Decoding GRIB needs cfgrib (`load_gfs_grib` raises an ImportError that
  says so without it); `build_gfs_init` takes decoded numpy cubes.
- The horizontal regrid (`ops.regrid`) and the log-pressure vertical
  interpolation run on the IC's device, all columns at once
  (`interp_columns`, the batched form of credit_tpu's per-column
  np.interp loop, `_interp_columns`, kept here as its plain reference).
- The result is the flat channels-last IC tensor the rollout takes, in
  ChannelSchema order.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from credit_torch import resolve_device
from credit_torch.data.channels import ChannelSchema
from credit_torch.ops.regrid import make_regridder
from credit_torch.physics.interp import _interp_monotonic, create_pressure_grid

logger = logging.getLogger(__name__)

# GFS short name -> ERA5-style variable (CREDIT nwp.py:100 _get_gfs_maps,
# the 'wchapmanera5' map)
GFS_MAP = {
    "ugrd": "U", "vgrd": "V", "tmp": "T", "spfh": "Q",
    "pressfc": "SP", "tmp2m": "VAR_2T", "ugrd10m": "VAR_10U",
    "vgrd10m": "VAR_10V", "hgtsfc": "Z_SFC", "dzdt": "W",
    "clwmr": "CLWMR", "o3mr": "O3MR",
}

GDAS_BASE = "gs://global-forecast-system/"


def build_file_path(date, base_path: str = GDAS_BASE, file_type: str = "atm",
                    step: str = "f000") -> str:
    """The GDAS object path of an init time (CREDIT nwp.py:145)."""
    ymd = f"{date.year:04d}{date.month:02d}{date.day:02d}"
    hh = f"{date.hour:02d}"
    return (f"{base_path.rstrip('/')}/gfs.{ymd}/{hh}/atmos/"
            f"gfs.t{hh}z.{'atmf000' if file_type == 'atm' else 'sfcf000'}"
            f".nc" if file_type in ("atm", "sfc") else base_path)


def load_gfs_grib(path: str, variables: Sequence[str]) -> Dict[str, np.ndarray]:
    """Decode a GFS GRIB2 file (needs cfgrib and xarray; CREDIT nwp.py:163)."""
    try:
        import cfgrib  # noqa: F401
        import xarray as xr
    except ImportError as e:
        raise ImportError(
            "GFS GRIB decoding needs cfgrib+xarray, which are not installed "
            "in this environment. Decode externally and pass numpy cubes to "
            "build_gfs_init(fields=...) instead.") from e
    ds = xr.open_dataset(path, engine="cfgrib")
    return {v: np.asarray(ds[v].values) for v in variables if v in ds}


def _interp_columns(var: np.ndarray, p_src: np.ndarray, p_dst: np.ndarray) -> np.ndarray:
    """Per-column log-pressure interpolation, one np.interp a column
    (credit_tpu/nwp.py:67-87, CREDIT nwp.py:267 _vertical_interpolation):
    the plain reference of `interp_columns`.

    var: (L_src, H, W); p_src: (L_src, H, W) or (L_src,); p_dst: (L_dst, H, W).
    """
    lsrc, h, w = var.shape
    if p_src.ndim == 1:
        p_src = np.broadcast_to(p_src[:, None, None], (lsrc, h, w))
    lv = np.log(np.maximum(p_src, 1e-3))
    lq = np.log(np.maximum(p_dst, 1e-3))
    out = np.empty((p_dst.shape[0], h, w), var.dtype)
    flat_v = var.reshape(lsrc, -1)
    flat_p = lv.reshape(lsrc, -1)
    flat_q = lq.reshape(p_dst.shape[0], -1)
    for col in range(flat_v.shape[1]):
        out.reshape(p_dst.shape[0], -1)[:, col] = np.interp(
            flat_q[:, col], flat_p[:, col], flat_v[:, col])
    return out


def interp_columns(var: torch.Tensor, p_src, p_dst: torch.Tensor) -> torch.Tensor:
    """`_interp_columns` for every column at once on var's device, f32:
    the pressures floored at 1e-3 Pa before the log, linear in log
    pressure, the column's end values outside its range, as np.interp.

    var: (L_src, H, W); p_src: (L_src,) or (L_src, H, W), increasing along
    the levels (np.interp's assumption; credit_tpu's loop returns
    meaningless values for decreasing ones, the port raises ValueError);
    p_dst: (L_dst, H, W). Returns (L_dst, H, W).
    """
    p_src = torch.as_tensor(p_src, dtype=torch.float32, device=var.device)
    if p_src.ndim == 1:
        p_src = p_src[:, None, None].expand(var.shape)
    if not bool((p_src[1:] >= p_src[:-1]).all()):
        raise ValueError("source pressures must increase along the levels")
    lv = torch.log(torch.clamp(p_src, min=1e-3)).movedim(0, -1)
    lq = torch.log(torch.clamp(p_dst, min=1e-3)).movedim(0, -1)
    v = var.movedim(0, -1)
    out = _interp_monotonic(lq, lv, v, use_log=False)
    # at and past the column's ends np.interp returns the end values as they are
    out = torch.where(lq <= lv[..., :1], v[..., :1], out)
    out = torch.where(lq >= lv[..., -1:], v[..., -1:], out)
    return out.movedim(-1, 0)


def build_gfs_init(schema: ChannelSchema, grid, fields: Dict[str, np.ndarray],
                   src_lat: np.ndarray, src_lon: np.ndarray,
                   src_pressure: Optional[np.ndarray] = None,
                   a_half: Optional[np.ndarray] = None,
                   b_half: Optional[np.ndarray] = None,
                   method: str = "bilinear",
                   variable_map: Optional[Dict[str, str]] = None,
                   static_fields: Optional[Dict[str, np.ndarray]] = None,
                   device="cuda") -> torch.Tensor:
    """A model IC from decoded NWP fields, built on `device` (CUDA unless
    the caller asks for the CPU).

    fields: {gfs_or_era5_name: (L, H_src, W_src) 3-D | (H_src, W_src) 2-D}
    src_pressure: the source's pressure levels (Pa), (L,) or (L, H_src, W_src)
    a_half/b_half: the target's hybrid coefficients: with SP regridded first
    the 3-D variables are interpolated onto the model's hybrid pressures
    (CREDIT nwp.py:267). Without them (a pure pressure-level target) the
    grid's `levels` are the target pressures.

    Returns the flat IC (1, 1, H, W, n_input), f32, in schema channel order.
    """
    dev = resolve_device(device)
    vmap = {**GFS_MAP, **(variable_map or {})}

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    named = {vmap.get(k, k): on_dev(v) for k, v in fields.items()}
    static_fields = {k: on_dev(v) for k, v in (static_fields or {}).items()}
    regrid = make_regridder(method, np.asarray(src_lat), np.asarray(src_lon),
                            np.asarray(grid.lat), np.asarray(grid.lon))
    regridded = {k: regrid(v) for k, v in named.items()}
    if "SP" not in regridded:
        raise KeyError("surface pressure ('SP'/'pressfc') is required to "
                       "build the vertical target grid")
    sp = regridded["SP"]

    # the target pressures of each column
    if a_half is not None and b_half is not None:
        _, p_full = create_pressure_grid(sp, np.asarray(a_half, np.float32),
                                         np.asarray(b_half, np.float32))
        p_dst = p_full.movedim(-1, 0)  # (L_dst, H, W)
    else:
        levels = torch.as_tensor(np.asarray(grid.levels, np.float32), device=dev)
        p_dst = levels[:, None, None].expand(len(levels), *sp.shape)

    interp = {}
    cols = []
    for e in schema.input_entries:
        base, sep, lev = e.name.rpartition("_L")
        if sep and lev.isdigit() and base in regridded:
            if base not in interp:
                if src_pressure is None:
                    raise ValueError(f"3-D variable {base} needs src_pressure")
                interp[base] = interp_columns(regridded[base], src_pressure, p_dst)
            cols.append(interp[base][int(lev)])
        elif e.name in regridded:
            cols.append(regridded[e.name])
        elif e.name in static_fields:
            f = static_fields[e.name]
            cols.append(f if f.shape == sp.shape else regrid(f))
        else:
            logger.warning("IC variable %s not in NWP fields; zero-filled", e.name)
            cols.append(torch.zeros_like(sp))
    return torch.stack(cols, dim=-1)[None, None]


def gefs_member_paths(init_date: str, members: int,
                      base: str = "gs://gfs-ensemble-forecast-system/") -> Dict[str, str]:
    """The GEFS members' object paths (CREDIT gefs.py:14 download_gefs_run
    naming: gec00 the control, gep01..gepNN)."""
    d = init_date.replace("-", "")
    out = {"c00": f"{base}gefs.{d[:8]}/{d[8:10] if len(d) > 8 else '00'}/"
                  f"atmos/pgrb2ap5/gec00.t00z.pgrb2a.0p50.f000"}
    for m in range(1, members + 1):
        out[f"p{m:02d}"] = out["c00"].replace("gec00", f"gep{m:02d}")
    return out


def unstagger_winds(u_s: np.ndarray, v_w: np.ndarray):
    """Staggered wind components averaged to the cell centres (CREDIT
    gefs.py:169 unstagger_winds)."""
    u_a = 0.5 * (u_s[..., :-1] + u_s[..., 1:])
    v_a = 0.5 * (v_w[..., :-1, :] + v_w[..., 1:, :])
    return u_a, v_a


def member_order(member_fields: Dict[str, Dict[str, np.ndarray]]):
    """The members in a fixed order: the control first, then p01..pNN
    (CREDIT gefs.py:206 assembles gec00 + gep## in member order)."""
    return sorted(member_fields, key=lambda k: (k not in ("c00", "gec00"), k))


def build_gefs_init(schema: ChannelSchema, grid,
                    member_fields: Dict[str, Dict[str, np.ndarray]],
                    src_lat: np.ndarray, src_lon: np.ndarray,
                    src_pressure: Optional[np.ndarray] = None,
                    a_half: Optional[np.ndarray] = None,
                    b_half: Optional[np.ndarray] = None,
                    method: str = "bilinear",
                    variable_map: Optional[Dict[str, str]] = None,
                    static_fields: Optional[Dict[str, np.ndarray]] = None,
                    device="cuda"):
    """The GEFS ensemble's IC: every member (the control gec00 and the
    perturbations gep01..gepNN) through `build_gfs_init`, stacked on the
    batch axis in `member_order`.

    member_fields: {member key: {var: array}}, each member's decoded cube.
    Returns ((E, 1, H, W, n_input) IC on `device`, [member keys in stack
    order]) (CREDIT gefs.py:206, feeding its ensemble realtime apps).
    """
    order = member_order(member_fields)
    ics = [build_gfs_init(schema, grid, member_fields[m], src_lat, src_lon,
                          src_pressure, a_half, b_half, method, variable_map,
                          static_fields, device)
           for m in order]
    return torch.cat(ics, dim=0), order

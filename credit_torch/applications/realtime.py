"""Realtime rollout: NWP (GFS) initial conditions -> forecast netCDF (port of
credit_tpu/applications/realtime.py).

CREDIT's realtime app (applications/rollout_realtime.py + credit/nwp.py:27)
as credit_tpu re-designed it: the IC is built from a decoded NWP analysis
(GRIB through cfgrib where installed, or a pre-decoded .npz cube) on the
device (`nwp.build_gfs_init`), the model rolls forward through the
RolloutEngine, which normalizes it on entry, and each step is written to
netCDF under the realtime init label.

npz layout of `realtime.fields_path`:
  lat (H,), lon (W,), pressure (L,) [Pa]   - the source grid
  <var> (L, H, W) or (H, W)                - GFS short names or ERA5 names
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from credit_torch import resolve_device

logger = logging.getLogger(__name__)


def load_fields_npz(path: str):
    """({var: array}, {lat, lon, pressure}) of a decoded-fields .npz file."""
    data = np.load(path)
    coords = {k: data[k] for k in ("lat", "lon", "pressure") if k in data}
    fields = {k: data[k] for k in data.files if k not in ("lat", "lon", "pressure")}
    return fields, coords


def run_realtime(conf: dict, n_steps: Optional[int] = None, save_dir: Optional[str] = None,
                 fields=None, coords=None, device="cuda"):
    """credit-torch realtime: the IC from the NWP fields, a rollout, the
    netCDF paths, on `device` (CUDA unless the caller asks for the CPU).

    The fields are `fields`/`coords`, else realtime.fields_path (npz),
    realtime.member_fields_paths ({member: npz}: the GEFS members, rolled
    out together on the batch axis) or realtime.grib_path. The static and
    forcing channels the analysis lacks come from the dataset's first valid
    input. The weights are save_loc's checkpoint folded for inference, with
    the config's postblocks (`experiment._load_engine`, as run_rollout).
    Step s goes to <save_dir>/<init_label>/pred_<init_label>_<FHR>.nc, a
    member's to <save_dir>/<member>/<init_label>/...; returns the paths."""
    from credit_torch.applications.experiment import _load_engine
    from credit_torch.nwp import build_gefs_init, build_gfs_init, load_gfs_grib
    from credit_torch.output import save_netcdf_increment

    dev = resolve_device(device)
    rconf = conf.get("realtime", {}) or {}
    n_steps = n_steps or int(rconf.get("forecast_steps",
                                       conf.get("predict", {}).get("forecast_steps", 4)))
    save_dir = save_dir or rconf.get("save_forecast") or os.path.join(
        conf.get("save_loc", "."), "realtime")
    lead_hours = int(conf.get("data", {}).get("lead_time_periods", 6))

    # an ensemble: the members' decoded cubes (the GEFS control and
    # perturbations) roll out together on the batch axis (CREDIT
    # applications/rollout_realtime_gefs.py + gefs.py:206)
    member_fields = None
    if fields is None and rconf.get("member_fields_paths"):
        member_fields = {}
        for key, p in dict(rconf["member_fields_paths"]).items():
            member_fields[key], coords = load_fields_npz(p)
    elif fields is None:
        if rconf.get("fields_path"):
            fields, coords = load_fields_npz(rconf["fields_path"])
        elif rconf.get("grib_path"):
            fields = load_gfs_grib(rconf["grib_path"], rconf.get("variables", []))
            coords = {"lat": np.asarray(rconf["src_lat"]),
                      "lon": np.asarray(rconf["src_lon"]),
                      "pressure": np.asarray(rconf["src_pressure"])}
        else:
            raise ValueError("realtime needs fields_path (npz), "
                             "member_fields_paths ({member: npz}), or grib_path")

    exp, engine = _load_engine(conf, dev)
    schema, grid = exp["schema"], exp["grid"]
    # the static and forcing channels the NWP analysis lacks come from the
    # dataset's IC at its first valid time (CREDIT keeps them model-side)
    static = {}
    try:
        x_ref = exp["dataset"].input_at(exp["dataset"].history_len)
        for e in schema.input_entries:
            if e.field_type in ("static", "dynamic_forcing"):
                static[e.name] = np.asarray(x_ref[-1, :, :, e.index])
    except Exception as e:  # noqa: BLE001 - a dataset without samples: none
        logger.debug("no dataset statics for realtime IC (%s)", e)
    ak = None if grid.ak is None else np.asarray(grid.ak)
    bk = None if grid.bk is None else np.asarray(grid.bk)
    members = None
    if member_fields is not None:
        ic, members = build_gefs_init(schema, grid, member_fields, coords["lat"],
                                      coords["lon"], coords.get("pressure"), a_half=ak,
                                      b_half=bk, static_fields=static, device=dev)
        logger.info("realtime ensemble: %d members (%s)", len(members), ", ".join(members))
    else:
        ic = build_gfs_init(schema, grid, fields, coords["lat"], coords["lon"],
                            coords.get("pressure"), a_half=ak, b_half=bk,
                            static_fields=static, device=dev)

    label = rconf.get("init_label", "realtime")
    written = []

    def writer(step, y):
        for i, out in enumerate([save_dir] if members is None
                                else [os.path.join(save_dir, m) for m in members]):
            written.append(save_netcdf_increment(y[i], schema, grid, out, label,
                                                 (step + 1) * lead_hours))

    # physical units: the engine normalizes on entry
    engine.run(ic, n_steps, on_step=writer)
    engine.close()
    logger.info("realtime: wrote %d files to %s", len(written), save_dir)
    return written

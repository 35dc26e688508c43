"""Offline ensemble verification over saved rollout netCDF trees: port of
credit_tpu/applications/ensemble_eval.py.

Evaluates forecasts written by `run_rollout` (`<root>/<init>/pred_*.nc`
control + `<init>_eNN/` member directories) without re-running the model
(reference: applications/ensemble_eval.py -- spread-error, binned
spread-skill, zonal and divergent/rotational KE spectra computed from
rollout files, credit/verification/ensemble.py:14,45 +
verification/standard.py:9,50).

Per (init, lead) row: ensemble-mean RMSE, spread, spread/skill ratio,
binned spread-skill calibration pairs, band-summed zonal error power, and
(when U/V are present) rotational/divergent kinetic-energy band sums. The
KE spectra share one SHT, built at the first U/V pair (credit_tpu's build
its tables in every call, one per U/V pair and lead: ~6-11 s each at 0.25
degrees).
"""

from __future__ import annotations

import json
import logging
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from credit_torch import resolve_device
from credit_torch.data.channels import ChannelSchema

logger = logging.getLogger(__name__)

_MEMBER_RE = re.compile(r"^(?P<base>.+?)_e(?P<num>\d+)$")


def flat_from_netcdf(ds, schema: ChannelSchema) -> np.ndarray:
    """Inverse of output.split_channels for one forecast file:
    {var or var(level)} -> (lat, lon, C_target) in schema channel order."""
    cols = []
    for e in schema.target_entries:
        base, sep, lev = e.name.rpartition("_L")
        if sep and lev.isdigit() and base in ds:
            cols.append(np.asarray(ds[base].values)[:, int(lev)][0])
        else:
            v = np.asarray(ds[e.name].values)
            cols.append(v[0] if v.ndim == 3 else v)  # strip time dim
    return np.stack(cols, axis=-1)


def discover_groups(root: str) -> Dict[str, List[str]]:
    """Group rollout directories into {init_label: [dir, member_dir, ...]}
    (control first, members `<init>_eNN` sorted)."""
    groups: Dict[str, List[str]] = defaultdict(list)
    for d in sorted(os.listdir(root)):
        if not os.path.isdir(os.path.join(root, d)):
            continue
        m = _MEMBER_RE.match(d)
        groups[m.group("base") if m else d].append(d)
    # keep only groups whose control dir exists
    return {b: ds for b, ds in groups.items() if b in ds}


def _leads(root: str, d: str) -> Dict[int, str]:
    out = {}
    for f in os.listdir(os.path.join(root, d)):
        m = re.match(rf"pred_{re.escape(d)}_(\d+)\.nc$", f)
        if m:
            out[int(m.group(1))] = os.path.join(root, d, f)
    return out


def _band_sums(spec: np.ndarray, n_bands: int = 3) -> List[float]:
    """Log-spaced wavenumber band sums (compact JSON summary of a spectrum)."""
    n = spec.shape[-1]
    edges = np.unique(np.geomspace(1, n, n_bands + 1).astype(int))
    return [float(spec[..., a:b].sum()) for a, b in zip(edges[:-1], edges[1:])]


def _init_index(base: str, dataset) -> Optional[int]:
    """The init's index on the dataset clock, for truth lookup: `initNNNN`
    labels carry the clock index (experiment._resolve_init_indices);
    datetime labels resolve through the dataset's timestamp clock."""
    m = re.match(r"init(\d+)$", base)
    if m:
        return int(m.group(1))
    if hasattr(dataset, "index_of"):
        md = re.match(r"(\d{4}-\d{2}-\d{2}T\d{2})Z$", base)
        if md:
            try:
                return dataset.index_of(md.group(1) + ":00:00")
            except (KeyError, ValueError):
                return None
    return None


def evaluate_tree(conf: dict, root: str, n_bins: int = 6, dataset=None,
                  device="cuda") -> List[dict]:
    """Verify every (init, lead) ensemble under `root` on one device (CUDA
    unless the caller asks for the CPU); rows are JSON-serializable dicts.
    Truth comes from the configured dataset when the init label maps onto
    its clock; otherwise truth-dependent metrics are skipped and only
    spread/spectra are reported. Only the config's data sections are
    built (credit_tpu builds its model too, and does not use it)."""
    from credit_torch import metrics
    from credit_torch.applications.experiment import build_data
    from credit_torch.ops.sht import SHT
    from credit_torch.utils.ncio import open_dataset

    dev = resolve_device(device)
    exp = build_data(conf)
    schema, grid = exp["schema"], exp["grid"]
    dataset = dataset or exp["dataset"]
    lead_hours = int(conf.get("data", {}).get("lead_time_periods", 6))
    w = torch.as_tensor(np.asarray(grid.coslat_weights(), np.float32), device=dev)[:, None, None]

    # U/V channel pairs for KE spectra (surface or per-level winds)
    names = [e.name for e in schema.target_entries]
    uv_pairs = [(names.index(u), names.index("V" + u[1:])) for u in names
                if u.startswith("U") and ("V" + u[1:]) in names]

    sht = None  # the spectra's SHT, built once for the grid
    rows: List[dict] = []
    for base, dirs in discover_groups(root).items():
        per_dir = {d: _leads(root, d) for d in dirs}
        common = sorted(set.intersection(*[set(v) for v in per_dir.values()]))
        init_idx = _init_index(base, dataset)
        for fhr in common:
            ens = torch.as_tensor(np.stack([flat_from_netcdf(open_dataset(per_dir[d][fhr]),
                                                             schema) for d in dirs]),
                                  device=dev)  # (E, lat, lon, C)
            row = {"init": base, "lead_hours": fhr, "n_members": len(dirs)}
            if len(dirs) > 1:
                e = ens[None]  # (1, E, lat, lon, C)
                row["spread"] = float(torch.sqrt((e.var(dim=1, correction=1) * w).mean()))
                truth = None
                if init_idx is not None:
                    t_idx = init_idx + fhr // lead_hours  # valid time
                    if t_idx < len(dataset):
                        truth = torch.as_tensor(dataset.target_at(t_idx)[0], device=dev)
                if truth is not None:
                    sp, rmse = metrics.spread_error(truth[None], e, w)
                    row["rmse"] = float(rmse)
                    row["spread_skill_ratio"] = float(sp / (rmse + 1e-12))
                    # latitude-band partition (reference
                    # verification/ensemble.py latitude_slices)
                    row.update(metrics.spread_error_regional(truth[None], e, grid.lat))
                    sb, rb, _ = metrics.binned_spread_skill(truth[None], e, n_bins)
                    row["bin_spread"] = [float(x) for x in sb]
                    row["bin_rmse"] = [float(x) for x in rb]
                    err = e.mean(dim=1)[0] - truth
                    row["error_zonal_power"] = _band_sums(
                        metrics.zonal_spectrum(err.movedim(-1, 0)).mean(dim=(0, 1)).cpu().numpy())
            for ui, vi in uv_pairs:
                if sht is None:
                    sht = SHT(np.asarray(grid.lat), grid.nlon, grid="equiangular", device=dev)
                ke_rot, ke_div = metrics.divergent_rotational_spectra(
                    ens[0][..., ui], ens[0][..., vi], grid, sht=sht)
                row[f"ke_rot_{names[ui]}"] = _band_sums(ke_rot.cpu().numpy())
                row[f"ke_div_{names[ui]}"] = _band_sums(ke_div.cpu().numpy())
            rows.append(row)
    return rows


def run_ensemble_eval(conf: dict, root: str, n_bins: int = 6, out_path: Optional[str] = None,
                      device="cuda") -> List[dict]:
    """evaluate_tree's rows, written as JSON to out_path (else printed)."""
    rows = evaluate_tree(conf, root, n_bins, device=device)
    payload = json.dumps(rows, indent=1)
    if out_path:
        with open(out_path, "w") as f:
            f.write(payload)
        logger.info("wrote %d rows to %s", len(rows), out_path)
    else:
        print(payload)
    return rows

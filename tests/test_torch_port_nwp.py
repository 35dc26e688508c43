"""Parity of the port's realtime ingest (nwp.py) and `credit-torch realtime`
(applications/realtime.py) with credit_tpu's: tests/test_nwp_realtime.py's
cases on the port, each IC against credit_tpu's within 1e-5 of each
channel's largest magnitude, the batched column interpolation against the
per-column np.interp loop on columns that run past both ends, the hybrid
target levels, and run_realtime's files, one IC and GEFS members, against
credit_tpu's from the same checkpoint by diff_rollout within 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu import nwp as jnwp
from credit_tpu.applications import experiment as jexperiment
from credit_tpu.applications import realtime as jrealtime
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.grid import Grid as JGrid
from credit_tpu.models import load_model as jax_load_model
from credit_torch import nwp
from credit_torch.applications.realtime import load_fields_npz, run_realtime
from credit_torch.data.channels import ChannelSchema
from credit_torch.grid import Grid
from credit_torch.utils.ncio import open_dataset
from tests.test_nwp_realtime import CONF, H, W, gfs_cube  # noqa: F401 (gfs_cube: a fixture)
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

LEVELS = [30000.0, 50000.0, 70000.0, 85000.0]
TOL = 1e-5


def _close_by_channel(got, want, tol=TOL):
    """Each channel (last axis) within tol of its largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.maximum(np.abs(want).reshape(-1, want.shape[-1]).max(0), 1e-30)
    err = np.abs(got - want).reshape(-1, want.shape[-1]).max(0)
    assert (err <= tol * scale).all(), err / scale


def _ic(fields, src_lat, src_lon, src_p, **kw):
    schema, jschema = ChannelSchema.from_config(CONF), JSchema.from_config(CONF)
    got = nwp.build_gfs_init(schema, Grid.regular(H, W, levels=LEVELS), fields, src_lat,
                             src_lon, src_p, device="cpu", **kw)
    want = jnwp.build_gfs_init(jschema, JGrid.regular(H, W, levels=LEVELS), fields, src_lat,
                               src_lon, src_p, **kw)
    return schema, got.numpy(), want


def test_build_gfs_init_shapes_and_physics(gfs_cube):
    fields, src_lat, src_lon, src_p = gfs_cube
    lsm = (np.random.default_rng(0).uniform(0, 1, (H, W)) > 0.5).astype(np.float32)
    schema, ic, want = _ic(fields, src_lat, src_lon, src_p, static_fields={"lsm": lsm})
    assert ic.shape == (1, 1, H, W, schema.n_input) and ic.dtype == np.float32
    assert np.isfinite(ic).all()
    _close_by_channel(ic, want)
    names = schema.input_names
    t3 = ic[0, 0, :, :, names.index("T_L0"):names.index("T_L3") + 1]
    assert (np.diff(t3, axis=-1) > 0).mean() > 0.97
    assert abs(t3[..., 1].mean() - (220 + 60 * 0.5)) < 3.0
    assert abs(ic[0, 0, :, :, names.index("SP")].mean() - 1.0e5) < 1e3
    np.testing.assert_array_equal(ic[0, 0, :, :, names.index("lsm")], lsm)


def test_build_gfs_init_hybrid_levels_and_other_regridders(gfs_cube):
    """Hybrid target levels (a + b * SP through physics/interp.py's
    create_pressure_grid), a static field on the source grid (regridded),
    a missing variable zero-filled, and the nearest and conservative
    regridders: each against credit_tpu's IC."""
    fields, src_lat, src_lon, src_p = gfs_cube
    a = np.array([0.0, 5000.0, 15000.0, 20000.0, 10000.0], np.float32)
    b = np.array([0.0, 0.05, 0.2, 0.45, 0.85], np.float32)
    lsm_src = np.random.default_rng(2).uniform(0, 1, fields["pressfc"].shape).astype(np.float32)
    for method in ("bilinear", "nearest", "conservative"):
        _, ic, want = _ic(fields, src_lat, src_lon, src_p, a_half=a, b_half=b, method=method,
                          static_fields={"lsm": lsm_src})
        _close_by_channel(ic, want)
    _, ic, want = _ic({k: v for k, v in fields.items() if k != "tmp"}, src_lat, src_lon, src_p)
    _close_by_channel(ic, want)
    assert not ic[..., :4].any()  # T_L0..T_L3, absent, are zero


def test_interp_columns_batched_matches_np_interp_loop():
    """Columns whose target pressures run past both ends of the source
    column (np.interp's end values there), source pressures as one
    profile and per column, floors below 1e-3 Pa: the batched form on the
    CPU against the per-column loop (the port's copy bitwise credit_tpu's)
    within 1e-5 of each level's largest value; decreasing source pressures
    raise in the port."""
    rng = np.random.default_rng(3)
    lsrc, h, w = 7, 9, 11
    p1 = np.sort(rng.uniform(5e3, 1e5, lsrc)).astype(np.float32)
    p1[0] = 0.0  # floored at 1e-3 Pa before the log
    p3 = (p1[:, None, None] * rng.uniform(0.9, 1.1, (1, h, w))).astype(np.float32)
    p3.sort(axis=0)
    var = rng.standard_normal((lsrc, h, w)).astype(np.float32)
    p_dst = np.sort(rng.uniform(-1e3, 1.3e5, (6, h, w)), axis=0).astype(np.float32)
    p_dst[0] = 1e-4  # below the column's top and the floor
    p_dst[-1] = 2e5  # below the surface
    for p_src in (p1, p3):
        want = nwp._interp_columns(var, p_src, p_dst)
        np.testing.assert_array_equal(want, jnwp._interp_columns(var, p_src, p_dst))
        got = nwp.interp_columns(torch.from_numpy(var), p_src, torch.from_numpy(p_dst)).numpy()
        _close_by_channel(np.moveaxis(got, 0, -1), np.moveaxis(want, 0, -1))
        np.testing.assert_array_equal(got[0], var[0])  # past the top: its value
        np.testing.assert_array_equal(got[-1], var[-1])  # past the surface: its value
    with pytest.raises(ValueError, match="increase"):
        nwp.interp_columns(torch.from_numpy(var), p1[::-1].copy(), torch.from_numpy(p_dst))


def test_missing_sp_raises(gfs_cube):
    fields, src_lat, src_lon, src_p = gfs_cube
    with pytest.raises(KeyError, match="surface pressure"):
        nwp.build_gfs_init(ChannelSchema.from_config(CONF), Grid.regular(H, W, levels=[50000.0]),
                           {k: v for k, v in fields.items() if k != "pressfc"},
                           src_lat, src_lon, src_p, device="cpu")


def test_grib_loader_degrades_gracefully(tmp_path):
    """cfgrib is absent here: an ImportError naming it."""
    with pytest.raises(ImportError, match="cfgrib"):
        nwp.load_gfs_grib(str(tmp_path / "x.grib2"), ["tmp"])


def test_paths_maps_and_member_order_match_reference():
    import datetime

    assert nwp.GFS_MAP == jnwp.GFS_MAP
    paths = nwp.gefs_member_paths("20240101", 3)
    assert paths == jnwp.gefs_member_paths("20240101", 3)
    assert set(paths) == {"c00", "p01", "p02", "p03"}
    assert "gep02" in paths["p02"] and "gec00" in paths["c00"]
    when = datetime.datetime(2024, 3, 5, 12)
    for ft in ("atm", "sfc", "other"):
        assert nwp.build_file_path(when, file_type=ft) == jnwp.build_file_path(when, file_type=ft)
    members = {"p02": {}, "gec00": {}, "p01": {}}
    assert nwp.member_order(members) == jnwp.member_order(members) == ["gec00", "p01", "p02"]


def test_unstagger_winds():
    u_s = np.arange(12, dtype=np.float32).reshape(3, 4)
    v_w = np.arange(12, dtype=np.float32).reshape(3, 4)
    u, v = nwp.unstagger_winds(u_s, v_w)
    ju, jv = jnwp.unstagger_winds(u_s, v_w)
    assert u.shape == (3, 3) and v.shape == (2, 4)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_allclose(u[0], [0.5, 1.5, 2.5])


def _members(fields, seed=7):
    rng = np.random.default_rng(seed)
    return {"p02": {k: v + rng.normal(0, 0.1, v.shape).astype(np.float32)
                    for k, v in fields.items()},
            "c00": fields,
            "p01": {k: v + rng.normal(0, 0.1, v.shape).astype(np.float32)
                    for k, v in fields.items()}}


def test_build_gefs_init_members(gfs_cube):
    """control first, (E, 1, H, W, C), the members apart, each against
    credit_tpu's."""
    fields, src_lat, src_lon, src_p = gfs_cube
    members = _members(fields)
    schema = ChannelSchema.from_config(CONF)
    ic, order = nwp.build_gefs_init(schema, Grid.regular(H, W, levels=LEVELS), members,
                                    src_lat, src_lon, src_p, device="cpu")
    want, jorder = jnwp.build_gefs_init(JSchema.from_config(CONF),
                                        JGrid.regular(H, W, levels=LEVELS), members,
                                        src_lat, src_lon, src_p)
    assert order == jorder == ["c00", "p01", "p02"]
    ic = ic.numpy()
    assert ic.shape == (3, 1, H, W, schema.n_input) and np.isfinite(ic).all()
    assert not np.allclose(ic[0], ic[1]) and not np.allclose(ic[1], ic[2])
    _close_by_channel(ic, want)


# --------------------------------------------------------------- run_realtime
def _realtime_conf(tmp_path, tag, realtime):
    return {
        "save_loc": str(tmp_path / tag / "ckpt"),
        "data": {**CONF["data"], "history_len": 1, "forecast_len": 1,
                 "lead_time_periods": 6, "n_times": 12},
        "trainer": {"type": "era5-v2", "learning_rate": 1e-3, "train_batch_size": 1,
                    "preflight": False},
        "model": {"type": "debugger", "image_height": H, "image_width": W, "levels": 4,
                  "channels": 2, "surface_channels": 1, "input_only_channels": 1,
                  "output_only_channels": 0, "frames": 1, "output_frames": 1},
        "loss": {"training_loss": "mse"},
        "realtime": {"forecast_steps": 2, "init_label": "2024-01-01T00Z",
                     "save_forecast": str(tmp_path / tag / "rt"), **realtime},
    }


def _shared_checkpoint(conf, jconf):
    """Seeded numpy weights of the debugger as a credit_tpu (orbax)
    checkpoint in both save_locs: credit_tpu restores it, the port reads it
    with tensorstore."""
    import orbax.checkpoint as ocp

    jmodel = jax_load_model(jconf)
    x = jnp.zeros((1, 1, H, W, JSchema.from_config(jconf).n_input), jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32), shapes["params"])
    for c in (conf, jconf):
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.abspath(os.path.join(c["save_loc"], "checkpoint")),
                   {"params": params, "spectral": {}, "step": np.zeros((), "int32")}, force=True)
        ckptr.wait_until_finished()


def _compare_trees(paths, jpaths, root, jroot):
    assert sorted(os.path.relpath(p, root) for p in paths) == sorted(
        os.path.relpath(p, jroot) for p in jpaths)
    for p in paths:
        ref = os.path.join(jroot, os.path.relpath(p, root))
        report = jexperiment.diff_rollout([p], ref, rtol=TOL, atol=TOL)
        assert report[0]["ok"], report


def test_realtime_app_end_to_end(tmp_path, gfs_cube):
    """npz fields -> realtime rollout -> netCDF, the files credit_tpu's
    run_realtime writes from the same checkpoint within 1e-5."""
    fields, src_lat, src_lon, src_p = gfs_cube
    npz = tmp_path / "fields.npz"
    np.savez(npz, lat=src_lat, lon=src_lon, pressure=src_p, **fields)
    loaded, coords = load_fields_npz(str(npz))
    assert sorted(loaded) == sorted(fields) and sorted(coords) == ["lat", "lon", "pressure"]
    conf = _realtime_conf(tmp_path, "port", {"fields_path": str(npz)})
    jconf = _realtime_conf(tmp_path, "jax", {"fields_path": str(npz)})
    _shared_checkpoint(conf, jconf)
    written = run_realtime(conf, device="cpu")
    jwritten = jrealtime.run_realtime(jconf)
    assert len(written) == 2
    files = sorted(os.listdir(tmp_path / "port" / "rt" / "2024-01-01T00Z"))
    assert files == ["pred_2024-01-01T00Z_006.nc", "pred_2024-01-01T00Z_012.nc"]
    _compare_trees(written, jwritten, tmp_path / "port" / "rt", tmp_path / "jax" / "rt")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_realtime(conf)


def test_realtime_ensemble_end_to_end(tmp_path, gfs_cube):
    """GEFS members' npz cubes -> one batched rollout -> a directory a
    member, the files credit_tpu's within 1e-5, the members apart."""
    fields, src_lat, src_lon, src_p = gfs_cube
    paths = {}
    for m, f in _members(fields, 11).items():
        p = tmp_path / f"{m}.npz"
        np.savez(p, lat=src_lat, lon=src_lon, pressure=src_p, **f)
        paths[m] = str(p)
    conf = _realtime_conf(tmp_path, "port", {"member_fields_paths": paths})
    jconf = _realtime_conf(tmp_path, "jax", {"member_fields_paths": paths})
    _shared_checkpoint(conf, jconf)
    written = run_realtime(conf, device="cpu")
    jwritten = jrealtime.run_realtime(jconf)
    assert len(written) == 6
    for m in ("c00", "p01", "p02"):
        files = sorted(os.listdir(tmp_path / "port" / "rt" / m / "2024-01-01T00Z"))
        assert files == ["pred_2024-01-01T00Z_006.nc", "pred_2024-01-01T00Z_012.nc"], (m, files)
    _compare_trees(written, jwritten, tmp_path / "port" / "rt", tmp_path / "jax" / "rt")
    a = open_dataset(str(tmp_path / "port" / "rt" / "c00" / "2024-01-01T00Z" /
                         "pred_2024-01-01T00Z_006.nc"))
    b = open_dataset(str(tmp_path / "port" / "rt" / "p01" / "2024-01-01T00Z" /
                         "pred_2024-01-01T00Z_006.nc"))
    assert max(np.abs(np.asarray(a[v].values) - np.asarray(b[v].values)).max()
               for v in a.keys()) > 1e-3


def test_realtime_needs_fields(tmp_path):
    with pytest.raises(ValueError, match="fields_path"):
        run_realtime(_realtime_conf(tmp_path, "none", {}), device="cpu")

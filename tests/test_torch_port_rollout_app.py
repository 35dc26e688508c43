"""Parity of the port's `credit rollout` with credit_tpu's: the metadata
table, the netCDF writer (output.py) and the downscaling transforms and
template writer, the init-time schedule (forecast.py and
_resolve_init_indices), rk4_step, RolloutEngine.run's writer pool, and
run_rollout end to end on the tiny CrossFormer from the seeded zarr store,
file for file through credit_tpu's own diff_rollout, f32 on the CPU.
"""

import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu import metadata as jmetadata
from credit_tpu import output as joutput
from credit_tpu import rollout as jrollout
from credit_tpu import transforms as jtransforms
from credit_tpu.applications import experiment as jexperiment
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.forecast import generate_forecasts as j_generate, strided_for_rank as j_strided
from credit_tpu.grid import Grid as JGrid
from credit_tpu.trainers import trainer as jtrainer
from credit_tpu.utils import ncio as jncio
from credit_torch import metadata, output, transforms
from credit_torch.applications import build_experiment, diff_rollout, run_rollout
from credit_torch.applications import experiment
from credit_torch.convert_jax import from_jax_variables, init_folded
from credit_torch.data.channels import ChannelSchema
from credit_torch.forecast import generate_forecasts, strided_for_rank
from credit_torch.grid import Grid
from credit_torch.rollout import RolloutEngine, rk4_step
from credit_torch.trainers.trainer import TrainState, load_trainer
from credit_torch.utils import ncio
# env is a fixture: imported, it applies here too
from tests.test_torch_port_fit import _jstate, env  # noqa: F401
from torch_port_fixtures import fit_conf
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

H, W = 32, 64
OUT_CONF = {"data": {"source": {"ERA5": {
    "levels": [0.0, 1.0, 2.0],
    "variables": {"prognostic": {"vars_3D": ["T", "Q"], "vars_2D": ["SP", "VAR_2T"]},
                  "diagnostic": {"vars_2D": ["total_precipitation", "unknown_var"]}}}}}}


# --------------------------------------------------------------- metadata, output
@pytest.mark.parametrize("name,conf", [
    ("T_L3", None), ("T", None), ("SP", None), ("unknown_var", None), ("Q_L0", None),
    ("T", {"metadata": {"T": {"units": "degC"}}}),
    ("new", {"metadata": {"new": {"units": "1", "long_name": "x"}}})])
def test_variable_attrs_match_reference(name, conf):
    assert metadata.variable_attrs(name, conf) == jmetadata.variable_attrs(name, conf)
    assert metadata.ERA5_ATTRS == jmetadata.ERA5_ATTRS


def _flat(schema, seed, t=2):
    return np.random.default_rng(seed).normal(size=(t, 4, 8, schema.n_target)).astype(np.float32)


def test_split_channels_and_make_xarray_match_reference():
    schema, jschema = ChannelSchema.from_config(OUT_CONF), JSchema.from_config(OUT_CONF)
    flat = _flat(schema, 1)
    got, want = output.split_channels(flat, schema), joutput.split_channels(flat, jschema)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["T"].shape == (2, 3, 4, 8) and got["SP"].shape == (2, 4, 8)
    grid = Grid.regular(4, 8, levels=[0.0, 1.0, 2.0])
    jgrid = JGrid.regular(4, 8, levels=[0.0, 1.0, 2.0])
    ds = output.make_xarray(flat, schema, grid, init_time="1979-01-01T00", lead_hours=12)
    jds = joutput.make_xarray(flat, jschema, jgrid, init_time="1979-01-01T00", lead_hours=12)
    assert list(ds.keys()) == list(jds.keys()) and ds.attrs == jds.attrs
    for k in jds.keys():
        assert ds[k].dims == jds[k].dims and ds[k].attrs == jds[k].attrs
        np.testing.assert_array_equal(np.asarray(ds[k].values), np.asarray(jds[k].values))
    for c in ("lat", "lon", "time", "level"):
        np.testing.assert_array_equal(np.asarray(ds.coords[c]), np.asarray(jds.coords[c]))


def _read(path, mod):
    ds = mod.open_dataset(path)
    return {k: (tuple(ds[k].dims), np.asarray(ds[k].values), dict(ds[k].attrs))
            for k in ds.keys()}, {c: np.asarray(v) for c, v in ds.coords.items()}


def test_save_netcdf_increment_matches_reference(tmp_path):
    """The same <save_dir>/<init>/pred_<init>_<FHR>.nc file, read back with
    the same variables, dimensions, CF attributes, values and coordinates."""
    schema, jschema = ChannelSchema.from_config(OUT_CONF), JSchema.from_config(OUT_CONF)
    flat = _flat(schema, 2, t=1)
    grid = Grid.regular(4, 8, levels=[0.0, 1.0, 2.0])
    p = output.save_netcdf_increment(flat, schema, grid, str(tmp_path / "port"), "init0003", 18)
    jp = joutput.save_netcdf_increment(flat, jschema, JGrid.regular(4, 8, levels=[0.0, 1.0, 2.0]),
                                       str(tmp_path / "jax"), "init0003", 18)
    assert os.path.relpath(p, tmp_path / "port") == os.path.relpath(jp, tmp_path / "jax") == \
        os.path.join("init0003", "pred_init0003_018.nc")
    (vars_, coords), (jvars, jcoords) = _read(p, ncio), _read(jp, jncio)
    assert list(vars_) == list(jvars)
    for k, (dims, values, attrs) in jvars.items():
        assert vars_[k][0] == dims and vars_[k][2] == attrs
        np.testing.assert_array_equal(vars_[k][1], values)
    assert vars_["SP"][2]["units"] == "Pa" and vars_["unknown_var"][2] == {}
    assert sorted(coords) == sorted(jcoords) == ["lat", "level", "lon", "time"]
    for c in jcoords:
        np.testing.assert_array_equal(coords[c], jcoords[c])


def _template(path, ny=5, nx=7):
    ncio.Dataset(
        {"T2": ncio.Variable(("time", "y", "x"), np.zeros((1, ny, nx), np.float32),
                             {"units": "K"}),
         "RAIN": ncio.Variable(("time", "y", "x"), np.zeros((1, ny, nx), np.float32)),
         "IGNORED": ncio.Variable(("time", "y", "x"), np.zeros((1, ny, nx), np.float32))},
        coords={"time": np.array([0.0]), "y": np.arange(ny, dtype=np.float64),
                "x": np.arange(nx, dtype=np.float64)}).to_netcdf(path)
    return path


def test_template_writer_and_downscaling_outputs_match_reference(tmp_path):
    """The cases of tests/test_downscaling_io.py on both writers: the same
    files, variables, attributes, values and time axis."""
    tpath = _template(str(tmp_path / "template.nc"))
    data = {"T2": np.full((2, 5, 7), 300.0, np.float32), "RAIN": np.full((2, 5, 7), 1.5,
                                                                         np.float32)}
    newtime = {"time": np.array([6.0, 12.0]), "units": "hours since 2020-01-01",
               "calendar": "noleap"}
    outs = {}
    for name, mod, nc in (("port", output, ncio), ("jax", joutput, jncio)):
        w = mod.TemplateWriter(tpath, out_vars=["T2", "RAIN"])
        out = str(tmp_path / f"{name}.nc")
        assert w.write(data, newtime, out) == out
        outs[name] = _read(out, nc)
        writers = {"wrf": mod.TemplateWriter(tpath, ["T2"]), "empty": mod.TemplateWriter(tpath, [])}
        assert writers["empty"].noop and writers["empty"].write(data, newtime, out) is None
        written = mod.write_downscaling_outputs(
            {"wrf": {"T2": np.ones((1, 5, 7), np.float32)}, "empty": {}}, writers,
            {"time": np.array([0.0]), "units": "h", "calendar": "standard"},
            str(tmp_path / f"{name}_dir"), "2020-01-01_00", prefix="fcst")
        assert [os.path.basename(p) for p in written] == ["fcst.wrf.2020-01-01_00.nc"]
        outs[name + "_ds"] = _read(written[0], nc)
    for key in ("", "_ds"):
        (v, c), (jv, jc) = outs["port" + key], outs["jax" + key]
        assert list(v) == list(jv)
        for k in jv:
            assert v[k][0] == jv[k][0] and v[k][2] == jv[k][2]
            np.testing.assert_array_equal(v[k][1], jv[k][1])
        assert sorted(c) == sorted(jc)
        for name in jc:
            np.testing.assert_array_equal(c[name], jc[name])
    assert "IGNORED" not in outs["port"][0] and outs["port"][0]["T2"][2]["units"] == "K"


# --------------------------------------------------------------- transforms
@pytest.mark.parametrize("name,kwargs", [
    ("minmax", {"mmin": 0.5, "mmax": 2.0}), ("zscore", {"mean": 1.2, "stdev": 0.4}),
    ("power", {"exponent": 0.5}), ("clip", {"cmin": 0.8}), ("clip", {"cmin": 0.6, "cmax": 1.5}),
    ("expand", {"by": 3}), ("pad", {"left": 1, "right": 2, "top": 3, "bottom": 1}),
    ("none", {})])
def test_transform_and_inverse_match_reference(name, kwargs):
    x = np.random.default_rng(3).uniform(0.5, 2.0, (3, 8, 8))
    t, jt = transforms.TRANSFORMS[name](**kwargs), jtransforms.TRANSFORMS[name](**kwargs)
    y = t(x)
    np.testing.assert_array_equal(y, jt(x))
    np.testing.assert_array_equal(t(y, inverse=True), jt(y, inverse=True))
    if name in ("minmax", "zscore", "power"):
        np.testing.assert_allclose(t(y, inverse=True), x, rtol=1e-10)
    if name in ("expand", "pad", "none"):
        np.testing.assert_array_equal(t(y, inverse=True), x)
    np.testing.assert_array_equal(transforms.rescale(x, 1.0, 2.0),
                                  jtransforms.rescale(x, 1.0, 2.0))


def test_data_transforms_match_reference(tmp_path):
    """The per-variable composition with netCDF parameter files (the case of
    tests/test_downscaling_io.py), forward and reversed."""
    ncio.Dataset({"T2": ncio.Variable(("s",), np.array([280.0], np.float32)),
                  "P": ncio.Variable(("s",), np.array([0.0], np.float32))}).to_netcdf(
        str(tmp_path / "mean.nc"))
    ncio.Dataset({"T2": ncio.Variable(("s",), np.array([10.0], np.float32)),
                  "P": ncio.Variable(("s",), np.array([2.0], np.float32))}).to_netcdf(
        str(tmp_path / "std.nc"))
    vardict = {"prognostic": ["T2"], "diagnostic": ["P"], "unused": ["junk"]}
    transdict = {"T2": {"zscore": "paramfile"},
                 "P": {"clip": {"cmin": 0.0}, "zscore": "paramfile"},
                 "paramfiles": {"mean": "mean.nc", "stdev": "std.nc"}}

    def x():
        return {"prognostic": {"T2": np.array([290.0, 270.0])},
                "diagnostic": {"P": np.array([-1.0, 4.0])}}

    dt_, jdt = (m.DataTransforms(vardict, transdict, rootpath=str(tmp_path))
                for m in (transforms, jtransforms))
    y, jy = dt_(x()), jdt(x())
    np.testing.assert_allclose(y["prognostic"]["T2"], [1.0, -1.0])
    for inv in (False, True):
        a = dt_(x(), inverse=inv) if inv else y
        b = jdt(x(), inverse=inv) if inv else jy
        for usage in a:
            for var in a[usage]:
                np.testing.assert_array_equal(a[usage][var], b[usage][var])
    with pytest.raises(ValueError):
        transforms.DataTransforms(vardict, transdict, dim="2D", zstride=2)


# --------------------------------------------------------------- init times
@pytest.mark.parametrize("pconf", [
    {"forecasts": {"start_year": 2020, "start_month": 1, "start_day": 5,
                   "start_hours": [0, 12], "duration": 3}},
    {"forecasts": {"start_year": 2021, "start_month": 6, "start_day": 1,
                   "start_hours": [0, 12], "duration": 3}},
    {"forecasts": ["2020-03-01T06:00:00", "2020-03-02T00:00:00"]},
    {"forecasts": {}}, {}])
def test_generate_forecasts_and_strides_match_reference(pconf):
    inits = generate_forecasts(pconf)
    assert inits == j_generate(pconf)
    for rank, world in ((0, 1), (1, 2), (2, 3), (0, 0)):
        assert strided_for_rank(inits, rank, world) == j_strided(inits, rank, world)
    if "duration" in pconf.get("forecasts", {}):
        assert len(inits) == 6 and inits[0].hour == 0 and inits[-1].hour == 12


class _DatetimeClock:
    history_len = 1

    def index_of(self, iso):
        return {"2020-01-05T00:00:00": 7, "2020-01-05T12:00:00": 9}[iso]


class _IntegerClock:
    history_len = 2

    def __len__(self):
        return 5


@pytest.mark.parametrize("pconf,dataset", [
    ({"forecasts": {"start_year": 2020, "start_month": 1, "start_day": 5,
                    "start_hours": [0, 12], "duration": 1}}, _DatetimeClock()),
    ({"forecasts": [3, 5]}, _IntegerClock()),
    ({"forecasts": {"start_hours": [0, 6, 12, 18], "duration": 1}}, _IntegerClock()),
    ({}, _IntegerClock()), ({"init_label": "ic"}, _DatetimeClock())])
def test_resolve_init_indices_match_reference(pconf, dataset):
    got = experiment._resolve_init_indices(pconf, dataset)
    assert got == jexperiment._resolve_init_indices(pconf, dataset)
    if isinstance(dataset, _DatetimeClock) and "forecasts" in pconf:
        assert got == [(7, "2020-01-05T00Z"), (9, "2020-01-05T12Z")]


# --------------------------------------------------------------- rollout engine
def test_rk4_step_matches_reference():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(6, 6)).astype(np.float32) * 0.3
    x = rng.normal(size=(2, 3, 6)).astype(np.float32)
    got = rk4_step(lambda v: torch.tanh(v @ torch.from_numpy(a)) + 0.5 * v, torch.from_numpy(x))
    want = jrollout.rk4_step(lambda v: jnp.tanh(v @ jnp.asarray(a)) + 0.5 * v, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_engine():
    from __graft_entry__ import TINY_MODEL_CONF

    conf = {**TINY_MODEL_CONF, "data": OUT_CONF["data"]}
    conf["model"] = {**conf["model"], "levels": 3, "channels": 2, "surface_channels": 2,
                     "input_only_channels": 0, "output_only_channels": 2}
    schema = ChannelSchema.from_config(conf)
    model = init_folded(conf, torch.Generator().manual_seed(0), device="cpu")
    x0 = torch.randn(1, 1, H, W, schema.n_input, generator=torch.Generator().manual_seed(1))
    return RolloutEngine(model, schema, device="cpu"), x0


def test_run_writer_pool(tiny_engine):
    """on_step runs on the writer threads, once for every step, each step's
    prediction as run returns it without on_step; every write has finished
    when run returns, although the later steps' writes are slow; outs
    arrays own their memory and differ from step to step."""
    engine, x0 = tiny_engine
    outs = engine.run(x0, 4)
    assert len(outs) == 4 and all(o.base is None and o.flags.owndata for o in outs)
    assert not np.array_equal(outs[0], outs[1])
    seen, threads = {}, set()

    def on_step(s, y):
        time.sleep(0.05 * s)
        threads.add(threading.get_ident())
        seen[s] = y.copy()

    assert engine.run(x0, 4, on_step=on_step, async_writers=2) == []
    assert sorted(seen) == [0, 1, 2, 3] and threading.get_ident() not in threads
    for s, o in enumerate(outs):
        np.testing.assert_array_equal(seen[s], o)


def test_run_writer_pool_under_contention(tiny_engine):
    """Eight writers on a tiny switch interval, each appending to a list
    without a lock and re-reading its array after a pause: every step
    arrives once, with the values run returns for it (a reused buffer would
    change them under a slow writer)."""
    engine, x0 = tiny_engine
    outs = engine.run(x0, 12)
    seen = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def on_step(s, y):
            first = y.copy()
            time.sleep(0.01 * (s % 3))
            seen.append((s, first, y.copy()))

        engine.run(x0, 12, on_step=on_step, async_writers=8)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(s for s, _, _ in seen) == list(range(12))
    for s, first, last in seen:
        np.testing.assert_array_equal(first, outs[s])
        np.testing.assert_array_equal(last, outs[s])


def test_run_raises_a_writer_error(tiny_engine):
    engine, x0 = tiny_engine
    done = []

    def on_step(s, y):
        if s == 1:
            raise OSError("disk full")
        done.append(s)

    with pytest.raises(OSError, match="disk full"):
        engine.run(x0, 5, on_step=on_step)
    assert 0 in done


# --------------------------------------------------------------- run_rollout
def _rollout_conf(env, save_loc, out, **predict):
    conf = fit_conf(env["store"], env["stats"], save_loc)
    conf["predict"] = {"forecasts": {"start_year": 1979, "start_month": 1, "start_day": 1,
                                     "start_hours": [12, 18], "duration": 1},
                       "forecast_steps": 2, "save_forecast": str(out), **predict}
    return conf


def _save_port_checkpoint(conf, variables, ema=None, card_noise=False):
    """The JAX variables as the port's checkpoint in conf's save_loc; with
    card_noise, holding a CUDA generator's state (16 bytes) as a fit on
    the card writes it."""
    exp = build_experiment(conf, device="cpu")
    trainer = load_trainer(conf)(conf, exp["model"], exp["loss"], exp["valid_loss"],
                                 exp["schema"], exp["dataset"], exp["valid_dataset"],
                                 save_loc=conf["save_loc"], normalizer=exp["normalizer"],
                                 device="cpu")
    trainer.model.load_state_dict(from_jax_variables(variables, conf, device="cpu", fold=False))
    state = TrainState.create(trainer.model, trainer.optimizer, ema=trainer.use_ema)
    if ema is not None:
        with torch.no_grad():
            for k, v in state.ema_params.items():
                v.copy_(ema[k])
    trainer.save_checkpoint(state, 0)
    if card_noise:
        path = os.path.join(conf["save_loc"], "checkpoint", trainer.CHECKPOINT_FILE)
        saved = torch.load(path, weights_only=True)
        saved["noise"] = torch.zeros(16, dtype=torch.uint8)
        torch.save(saved, path)


def test_run_rollout_matches_reference(env, tmp_path, monkeypatch):
    """credit_tpu's run_rollout with its own save_loc and no checkpoint, and
    the port's from a checkpoint of the same weights (carried across by
    convert_jax): the same <init>/pred_<init>_<FHR>.nc files for two init
    times of two steps, every variable within 1e-5 of its maximum by
    credit_tpu's diff_rollout, and the port's diff_rollout reporting the
    same. credit_tpu's fresh init of the tiny CrossFormer takes ~60 s on the
    CPU (its eager flax init), so its Trainer.init_state hands over the
    seeded numpy weights of tests/test_torch_port_fit.py instead; the rest
    of its run_rollout runs as it is (the warning, converge_spectral, its
    RolloutEngine with the tracer fixer and its writer pool)."""
    monkeypatch.setattr(jtrainer.Trainer, "init_state",
                        lambda self, rng: _jstate(env["variables"], None))
    jconf = _rollout_conf(env, tmp_path / "jax", tmp_path / "jax_out")
    jpaths = jexperiment.run_rollout(jconf)
    conf = _rollout_conf(env, tmp_path / "port", tmp_path / "port_out")
    _save_port_checkpoint(conf, env["variables"])
    paths = run_rollout(conf, device="cpu")
    rel = sorted(os.path.relpath(p, tmp_path / "port_out") for p in paths)
    assert rel == sorted(os.path.relpath(p, tmp_path / "jax_out") for p in jpaths) == [
        os.path.join(f"1979-01-01T{h}Z", f"pred_1979-01-01T{h}Z_{f:03d}.nc")
        for h in (12, 18) for f in (6, 12)]
    report = jexperiment.diff_rollout(paths, str(tmp_path / "jax_out"), rtol=1e-5, atol=1e-5)
    assert len(report) == 4 and all(r["ok"] for r in report), report
    assert {n for r in report for n in r["vars"]} == {"U", "T", "SP", "T2M", "PRECIP"}
    ours = diff_rollout(paths, str(tmp_path / "jax_out"), rtol=1e-5, atol=1e-5)
    assert [(r["path"], r["ref"], r["vars"]) for r in ours] == [
        (r["path"], r["ref"], r["vars"]) for r in report]


def test_run_rollout_weights_and_refusals(env, tmp_path, caplog):
    """use_ema rolls out the checkpoint's EMA: the same files as a
    checkpoint whose parameters are that EMA (the checkpoint written on a
    card, its noise generator's state a CUDA one); without a checkpoint the port
    warns and rolls out a seeded init; an ensemble of 2 writes each init's
    member directory <init>_e01 beside the control (its parity with
    credit_tpu: tests/test_torch_port_ensemble_apps.py); the card is the
    default device."""
    rng = np.random.default_rng(7)
    moved = jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.1 * rng.standard_normal(a.shape))).astype(np.float32),
        env["variables"]["params"])
    ema_vars = {"params": moved, "spectral": env["variables"]["spectral"]}
    conf = _rollout_conf(env, tmp_path / "a", tmp_path / "a_out")
    _save_port_checkpoint(conf, env["variables"], card_noise=True,
                          ema=from_jax_variables(ema_vars, conf, device="cpu", fold=False))
    paths = run_rollout(conf, use_ema=True, device="cpu")
    plain = run_rollout({**conf, "predict": {**conf["predict"], "save_forecast":
                                             str(tmp_path / "p_out")}}, device="cpu")
    conf_b = _rollout_conf(env, tmp_path / "b", tmp_path / "b_out")
    _save_port_checkpoint(conf_b, ema_vars)
    want = run_rollout(conf_b, device="cpu")
    assert all(r["ok"] for r in diff_rollout(paths, str(tmp_path / "b_out"), 0.0, 0.0))
    assert not all(r["ok"] for r in diff_rollout(plain, str(tmp_path / "b_out"), 1e-3, 1e-3))
    assert len(want) == 4
    fresh = _rollout_conf(env, tmp_path / "none", tmp_path / "none_out", forecast_steps=1,
                          forecasts=None)
    with caplog.at_level("WARNING"):
        assert len(run_rollout(fresh, device="cpu")) == 1
    assert "no checkpoint" in caplog.text
    ens = run_rollout(_rollout_conf(env, tmp_path, tmp_path / "e", ensemble_size=2),
                      device="cpu")
    assert sorted(os.listdir(tmp_path / "e")) == [
        "1979-01-01T12Z", "1979-01-01T12Z_e01", "1979-01-01T18Z", "1979-01-01T18Z_e01"]
    assert sorted(os.path.relpath(p, tmp_path / "e") for p in ens) == sorted(
        os.path.join(d, f"pred_{d}_{f:03d}.nc") for d in os.listdir(tmp_path / "e")
        for f in (6, 12))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_rollout(conf)

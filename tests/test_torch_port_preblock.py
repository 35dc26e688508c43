"""Parity of the port's preblocks (credit_torch/preblock) with credit_tpu's:
each ported block on seeded inputs, the bridgescaler transform in its three
kinds both ways (quantile tables with ties, inputs past the table), phase
filtering and grid wiring of build_preblocks, the blocks of ROADMAP queue 1
steps 2 and 4 (regrid, hybrid_level_interp, semilagrangian_advection), and
one train step and one 2-step eval step with
both preblock phases on the tiny CrossFormer, against credit_tpu's steps,
f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu import losses as jlosses
from credit_tpu import preblock as jpre
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.data.normalize import Normalizer as JNormalizer
from credit_tpu.grid import Grid as JGrid
from credit_tpu.trainers import trainer as jtrainer
from credit_torch import metrics as tmetrics
from credit_torch import preblock as tpre
from credit_torch import registry
from credit_torch.convert_jax import from_jax_variables
from credit_torch.data.channels import ChannelSchema
from credit_torch.data.normalize import Normalizer
from credit_torch.grid import Grid
from credit_torch.losses import WeightedLoss
from credit_torch.models import load_model
from credit_torch.trainers import trainer as ttrainer
from credit_torch.trainers.scheduler import constant
# env is a fixture: imported, it applies here too
from tests.test_torch_port_fit import _close, _jstate, _step_parts, env  # noqa: F401
from torch_port_fixtures import TRAINER, fit_conf, jit_lowopt
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

CONF = {"data": {"source": {"E": {
    "levels": [0.0, 1.0, 2.0],
    "variables": {"prognostic": {"vars_3D": ["U", "Q"], "vars_2D": ["SP", "precip"]},
                  "dynamic_forcing": {"vars_2D": ["tsi"]}}}}}}
# the preblocks of the steps: an IC clamp, then every step NaN/inf filled
# and log1p of a 3-D and a 2-D variable (in normalized units, so the clip
# at 0 takes about half of each)
STEP_PREBLOCKS = [{"type": "clamp", "phase": "ic_only", "min": -1.5, "max": 1.5},
                  {"type": "fill_values", "fill_value": 0.25},
                  {"type": "log_transform", "variables": ["T", "SP"], "epsilon": 0.1}]


def _input(schema, seed, shape=(2, 1, 6, 8)):
    """Seeded input with NaN, +inf and -inf cells and a positive Q."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 3.0, (*shape, schema.n_input)).astype(np.float32)
    x[0, 0, 0, 0, 0], x[1, 0, 2, 3, 4], x[0, 0, 5, 7, -1] = np.nan, np.inf, -np.inf
    for i, n in enumerate(schema.input_names):
        if n.startswith("Q"):
            x[..., i] = rng.uniform(0.0, 0.02, shape)
    return x


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin & ~np.isnan(want)], want[~fin & ~np.isnan(want)])
    scale = np.maximum(np.abs(want[fin]), 1e-30)
    assert (np.abs(got[fin] - want[fin]) <= tol * scale).all(), (
        np.abs(got[fin] - want[fin]) / scale).max()


def _normalizers(schema, jschema, seed=4):
    rng = np.random.default_rng(seed)
    mean = {"U": rng.normal(size=3), "Q": rng.uniform(0, 0.01, 3), "SP": 1e5, "precip": 1e-3,
            "tsi": 300.0}
    std = {"U": rng.uniform(1, 5, 3), "Q": rng.uniform(1e-3, 2e-3, 3), "SP": 900.0,
           "precip": 2e-3, "tsi": 150.0}
    return (Normalizer.from_stats_dict(schema, mean, std),
            JNormalizer.from_stats_dict(jschema, mean, std))


@pytest.mark.parametrize("entry", [
    {"type": "era5_normalizer"},
    {"type": "log_transform", "variables": ["Q", "precip"]},
    {"type": "log_transform", "variables": ["U"], "epsilon": 2.0},
    {"type": "sqrt_transform", "variables": ["Q", "SP"]},
    {"type": "fill_values"},
    {"type": "fill_values", "fill_value": -7.5},
    {"type": "clamp"},
    {"type": "clamp", "min": -2.0, "max": 3.0}], ids=lambda e: "-".join(map(str, e.values())))
def test_block_matches_reference(entry):
    """Each ported block, f32, within 1e-6 relative of credit_tpu's (NaN and
    inf where credit_tpu leaves them)."""
    schema, jschema = ChannelSchema.from_config(CONF), JSchema.from_config(CONF)
    norm, jnorm = _normalizers(schema, jschema)
    conf = {"preblocks": [entry]}
    (blk,) = tpre.build_preblocks(conf, schema, norm)
    (jblk,) = jpre.build_preblocks(conf, jschema, jnorm)
    x = _input(schema, 1)
    if entry["type"] == "era5_normalizer":
        x = np.nan_to_num(x, posinf=1.0, neginf=-1.0)
    got = blk(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    _rel_close(got.numpy(), np.asarray(jblk(jnp.asarray(x))), 1e-6)


def _quantile_table(rng, c):
    """Per-channel quantiles of skewed samples, with runs of equal values
    (a channel at 0 for its lowest fifth, one flat in the middle, one
    ending on a repeated maximum)."""
    qs = np.linspace(0, 100, 41)
    data = [rng.gamma(1.5, 2.0, 3000), rng.normal(3.0, 2.0, 3000), rng.uniform(-1, 1, 3000)]
    data[0][:700] = 0.0
    data[1][1400:1700] = 3.0
    data[2][-300:] = 1.0
    return np.stack([np.percentile(d, qs) for d in data[:c]]), data


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["quantile", "standard", "minmax"])
def test_bridgescaler_matches_reference(tmp_path, kind, inverse):
    """bridgescaler_transform from a written scaler.npz, forward and
    inverse, within 1e-5 of credit_tpu's: the quantile form through tied
    quantiles (each tie's value itself among the inputs) and inputs past
    both ends of the table."""
    rng = np.random.default_rng(5)
    table, data = _quantile_table(rng, 3)
    samples = np.stack([rng.choice(d, 600) for d in data], -1)
    np.savez(tmp_path / "scaler.npz", quantiles=table, mean=samples.mean(0),
             std=samples.std(0), min=samples.min(0), max=samples.max(0))
    x = np.stack([rng.choice(d, 40 * 30) for d in data], -1).reshape(1, 1, 40, 30, 3)
    x[0, 0, 0, :3] = [table[0, 0] - 5.0, table[1, 20], table[2, -1] + 1.0]
    x[0, 0, 1, :3] = [table[0, -1] + 9.0, table[1, 0] - 4.0, table[2, -1]]
    x[0, 0, 2, :3] = table[:, 3]  # on a tie of channel 0
    if inverse:
        x = rng.normal(0.0, 1.5, x.shape)
        x[0, 0, 0, :3] = [-9.0, 9.0, 0.0]
    x = x.astype(np.float32)
    args = dict(path=str(tmp_path / "scaler.npz"), kind=kind, inverse=inverse)
    got = registry.get("preblock", "bridgescaler_transform")(**args)(torch.from_numpy(x))
    want = np.asarray(jpre.BridgeScalerTransform(**args)(jnp.asarray(x)))
    assert np.isfinite(want).all() and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_interp_matches_jnp_interp():
    """The port's interpolation against jnp.interp on knots with ties at
    the start, the middle and the end, at the knots themselves and past
    both ends."""
    rng = np.random.default_rng(6)
    xp = np.sort(rng.normal(size=(3, 25)), 1).astype(np.float32)
    xp[0, :4], xp[1, 9:14], xp[2, -5:] = xp[0, 0], xp[1, 9], xp[2, -5]
    fp = np.sort(rng.uniform(size=(3, 25)), 1).astype(np.float32)
    x = rng.normal(0.0, 2.0, (3, 400)).astype(np.float32)
    x[:, :25] = xp
    got = tpre._interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
    want = np.stack([np.asarray(jnp.interp(x[c], xp[c], fp[c])) for c in range(3)])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_build_preblocks_phases_and_grid(monkeypatch):
    """Phase filtering (per_step is the default), the config's order kept,
    and the grid handed to the blocks that take one (mirrors
    tests/test_preblock_extras.py::test_build_preblocks_wires_grid)."""
    schema = ChannelSchema.from_config(CONF)
    seen = []

    class Recorder(tpre.BasePreblock):
        def __init__(self, schema=None, grid=None, **kw):
            seen.append((grid, kw))

    monkeypatch.setitem(registry._REGISTRIES["preblock"], "regrid", Recorder)
    monkeypatch.setitem(registry._REGISTRIES["preblock"], "semilagrangian_advection", Recorder)
    grid = Grid.regular(8, 16, levels=[0.0, 1.0, 2.0])
    conf = {"preblocks": [
        {"type": "clamp", "min": -5, "max": 5},
        {"type": "semilagrangian_advection", "phase": "ic_only", "tracer_vars": ["Q"]},
        {"type": "fill_values", "phase": "per_step"},
        {"type": "regrid", "phase": "ic_only", "src_lat": [1.0]},
        {"type": "sqrt_transform", "phase": "other", "variables": ["Q"]}]}
    per_step = tpre.build_preblocks(conf, schema, phase="per_step", grid=grid)
    ic = tpre.build_preblocks(conf, schema, phase="ic_only", grid=grid)
    assert [type(b).__name__ for b in per_step] == ["Clamp", "FillValues"]
    assert [type(b).__name__ for b in ic] == ["Recorder", "Recorder"]
    assert [g for g, _ in seen] == [grid, grid]
    assert seen[0][1]["tracer_vars"] == ["Q"] and seen[1][1]["src_lat"] == [1.0]
    assert tpre.build_preblocks({}, schema) == []
    x = torch.from_numpy(_input(schema, 2))
    out = tpre.apply_preblocks(per_step, x)
    assert torch.isfinite(out).all() and out.abs().max() <= 5
    assert tpre.apply_preblocks([], x) is x


@pytest.mark.parametrize("key,step", [("regrid", "step 2 (item 4)"),
                                      ("hybrid_level_interp", "step 4 (item 5)"),
                                      ("semilagrangian_advection", "step 4 (item 5)")])
def test_unported_blocks_raise_with_their_step(key, step):
    """The three blocks ROADMAP queue 1 ported in its steps 2 and 4 build
    through build_preblocks and match credit_tpu's: regrid (ops/regrid.py,
    step 2) onto the model grid within 1e-6 of max |x| (its methods and
    orderings: tests/test_torch_port_grid_ops.py); hybrid_level_interp and
    semilagrangian_advection (physics/interp.py and physics/advection.py,
    step 4) on a 9x16 grid with physical surface pressures, within 1e-5 of
    each channel's largest value (the winds are U for both components and
    0 on the pole rows, where cos(lat) is floored and the departure points
    are ill-conditioned; tests/test_torch_port_physics.py holds them
    there), the other channels bitwise untouched."""
    assert step.startswith("step")
    schema = ChannelSchema.from_config(CONF)
    jschema = JSchema.from_config(CONF)
    if key == "regrid":
        entry = {"type": key, "phase": "ic_only", "method": "bilinear",
                 "src_lat": np.linspace(-80.0, 80.0, 6).tolist(),
                 "src_lon": (np.arange(12) * 30.0 - 180.0).tolist()}
        (ours,) = tpre.build_preblocks({"preblocks": [entry]}, schema, phase="ic_only",
                                       grid=Grid.regular(8, 16))
        (ref,) = jpre.build_preblocks({"preblocks": [entry]}, jschema,
                                      phase="ic_only", grid=JGrid.regular(8, 16))
        x = np.random.default_rng(3).standard_normal((2, 1, 6, 12, schema.n_input))
        x = x.astype(np.float32)
        got, want = ours(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x)))
        assert got.shape == want.shape == (2, 1, 8, 16, schema.n_input)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(x).max()
        return
    ak, bk = [0.0, 3000.0, 2000.0, 0.0], [0.0, 0.3, 0.7, 1.0]
    args = ({"variables": ["U", "Q"], "ak_in": ak, "bk_in": bk,
             "ak_out": [0.0, 1500.0, 1000.0, 0.0], "bk_out": [0.0, 0.2, 0.6, 1.0]}
            if key == "hybrid_level_interp" else
            {"a_half": ak, "b_half": bk, "tracer_vars": ["Q"], "V_var": "U"})
    entry = {"type": key, "phase": "ic_only", **args}
    (ours,) = tpre.build_preblocks({"preblocks": [entry]}, schema, phase="ic_only",
                                   grid=Grid.regular(9, 16))
    (ref,) = jpre.build_preblocks({"preblocks": [entry]}, jschema, phase="ic_only",
                                  grid=JGrid.regular(9, 16))
    rng = np.random.default_rng(5)
    x = rng.normal(0.0, 8.0, (2, 1, 9, 16, schema.n_input)).astype(np.float32)
    for i, n in enumerate(schema.input_names):
        if n == "SP":
            x[..., i] = rng.uniform(6.0e4, 1.05e5, x.shape[:-1])
        elif n.startswith("Q"):
            x[..., i] = rng.uniform(0.0, 0.02, x.shape[:-1])
        elif n.startswith("U"):
            x[:, :, [0, -1], :, i] = 0.0
    got, want = ours(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x)))
    moved = np.abs(want - x).max(axis=(0, 1, 2, 3)) > 0
    assert moved.any()
    np.testing.assert_array_equal(got[..., ~moved], x[..., ~moved])
    scale = np.abs(want).max(axis=(0, 1, 2, 3))
    assert (np.abs(got - want).max(axis=(0, 1, 2, 3)) <= 1e-5 * scale).all()


# --------------------------------------------------------------- steps
def _metrics_close(met, jmet):
    """Each metric kind within 1e-5 of its largest channel."""
    for kind in tmetrics.KINDS:
        keys = [k for k in jmet if k == kind or k.startswith(kind + "_")]
        _close([float(met[k]) for k in keys], [float(jmet[k]) for k in keys], 1e-5, kind)


def _step_setup(env, flen):
    conf = fit_conf(env["store"], env["stats"], env["root"] / "unused")
    conf["preblocks"] = STEP_PREBLOCKS
    parts = _step_parts(env, conf, flen)
    jschema, schema, jnorm, tnorm = parts[:4]
    pre = {ph: tpre.build_preblocks(conf, schema, tnorm, ph, Grid.regular(32, 64))
           for ph in ("ic_only", "per_step")}
    jpre_ = {ph: tuple(jpre.build_preblocks(conf, jschema, jnorm, ph)) for ph in pre}
    assert [type(b).__name__ for b in pre["ic_only"]] == ["Clamp"]
    assert [type(b).__name__ for b in pre["per_step"]] == ["FillValues", "LogTransform"]
    model = load_model(conf, device="cpu", sn_state=True)
    model.load_state_dict(from_jax_variables(env["variables"], conf, device="cpu", fold=False))
    return conf, parts, pre, jpre_, model


def test_train_step_with_preblocks_matches_reference(env):
    """One train step with the IC clamp and the per-step fill and log1p, the
    Normalizer, the tracer fixer, metrics and the final state, against
    credit_tpu's make_train_step with the same preblocks: loss, gradient
    norm, the metrics (each kind against its largest channel) and the final
    state within 1e-5 (the tolerances of tests/test_torch_port_fit.py::
    test_train_step_with_pipeline_matches_reference); without the preblocks
    the loss differs."""
    conf, parts, pre, jpre_, model = _step_setup(env, 1)
    jschema, schema, jnorm, tnorm, jpost, tpost, jm, tm, raw = parts
    grid = Grid.regular(32, 64)
    jopt = jtrainer.make_optimizer(conf, lambda n: TRAINER["learning_rate"])
    jstep = jit_lowopt(jtrainer.make_train_step(
        env["jmodel"], jlosses.WeightedLoss.from_config(conf, grid), jopt, jschema,
        ema_decay=0.99, normalizer=jnorm, preblocks=jpre_["per_step"],
        preblocks_ic=jpre_["ic_only"], postblocks=tuple(jpost), metrics_fn=jm,
        return_final_state=True))
    _, jmet = jstep(_jstate(env["variables"], jopt, 1.0),
                    {k: jnp.asarray(v) for k, v in raw.items()}, jax.random.PRNGKey(0))
    opt = ttrainer.make_optimizer(conf, constant(TRAINER["learning_rate"]))
    loss = WeightedLoss.from_config(conf, grid)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    step = ttrainer.make_train_step(model, loss, opt, schema, ema_decay=0.99, normalizer=tnorm,
                                    preblocks=pre["per_step"], preblocks_ic=pre["ic_only"],
                                    postblocks=tpost, metrics_fn=tm, return_final_state=True,
                                    device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, met = step(ttrainer.TrainState.create(model, opt, ema=True), batch)
    assert set(met) == set(jmet) and met["finite"] == 1.0
    for k in ("loss", "grad_norm"):
        _close(float(met[k]), float(jmet[k]), 1e-5, k)
    _metrics_close(met, jmet)
    _close(met["_final_x"].numpy(), np.asarray(jmet["_final_x"]), 1e-5, "_final_x")
    model.load_state_dict(before)
    plain = ttrainer.make_train_step(model, loss, opt, schema, normalizer=tnorm,
                                     postblocks=tpost, device="cpu")
    _, met0 = plain(ttrainer.TrainState.create(model, opt), batch)
    assert abs(float(met0["loss"]) - float(met["loss"])) > 1e-3 * float(met["loss"])


def test_eval_step_with_preblocks_matches_reference(env):
    """A 2-step validation rollout with the IC clamp once and the per-step
    blocks on each step's input: loss and metrics within 1e-5 of
    credit_tpu's make_eval_step with the same preblocks."""
    conf, parts, pre, jpre_, model = _step_setup(env, 2)
    jschema, schema, jnorm, tnorm, jpost, tpost, jm, tm, raw = parts
    jeval = jit_lowopt(jtrainer.make_eval_step(
        env["jmodel"], jlosses.WeightedLoss(base="mse"), jschema, forecast_len=2,
        normalizer=jnorm, metrics_fn=jm, preblocks=jpre_["per_step"],
        preblocks_ic=jpre_["ic_only"], postblocks=tuple(jpost)))
    jmet = jeval(_jstate(env["variables"], None), {k: jnp.asarray(v) for k, v in raw.items()},
                 jax.random.PRNGKey(1))
    evaluate = ttrainer.make_eval_step(model, WeightedLoss(base="mse"), schema, forecast_len=2,
                                       normalizer=tnorm, metrics_fn=tm,
                                       preblocks=pre["per_step"], preblocks_ic=pre["ic_only"],
                                       postblocks=tpost, device="cpu")
    met = evaluate(ttrainer.TrainState(0, model, {}), {k: torch.from_numpy(v)
                                                       for k, v in raw.items()})
    assert set(met) == set(jmet)
    _close(float(met["loss"]), float(jmet["loss"]), 1e-5, "loss")
    _metrics_close(met, jmet)

"""Parity of the PyTorch port's training loop with credit_tpu's: the
latitude-weighted metrics, the train step with a Normalizer, a stateless
postblock, metrics and the final state, the eval step on EMA weights,
`Trainer.fit` on a zarr ERA5 store (training_log.csv cell by cell),
checkpoint and resume, early stopping, the rollout schedule, replay and
the trainer registry.

The tiny CrossFormer (TINY_MODEL_CONF) takes the same numpy weights on both
sides (tests/test_torch_port_model.py:_numpy_variables, bridged with
from_jax_variables), in f32 on the CPU: the JAX model takes its XLA
composition, the port's kernels their plain PyTorch versions. One
credit_tpu fit is shared by the module.
"""

import copy
import csv
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import TINY_MODEL_CONF
from credit_tpu import losses as jlosses
from credit_tpu import metrics as jmetrics
from credit_tpu.data import local as jlocal
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.data.normalize import Normalizer as JNormalizer
from credit_tpu.grid import Grid as JGrid
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.postblock import build_postblocks as j_build_postblocks
from credit_tpu.trainers import preflight as jpreflight
from credit_tpu.trainers import trainer as jtrainer
from credit_torch import metrics as tmetrics
from credit_torch.applications import build_experiment, prepare_training, run_training
from credit_torch.convert_jax import from_jax_variables
from credit_torch.data import zarrlite as tzarr
from credit_torch.data.channels import ChannelSchema
from credit_torch.data.era5 import ZarrSourceDataset
from credit_torch.data.normalize import Normalizer
from credit_torch.grid import Grid
from credit_torch.losses import WeightedLoss
from credit_torch.models import load_model
from credit_torch.postblock import build_postblocks
from credit_torch.trainers import preflight as tpreflight
from credit_torch.trainers import trainer as ttrainer
from credit_torch.trainers.scheduler import constant
from credit_torch.trainers.trainer import (Trainer, TrainState, load_trainer, make_eval_step,
                                           make_optimizer, make_train_step)
from credit_torch.utils import ncio as tncio
from torch_port_fixtures import (TRAINER, fit_conf, jit_lowopt,  # noqa: F401
                                 two_torch_threads, write_era5_store, write_stats)
from tests.test_torch_port_model import _numpy_variables, _to_numpy

H, W = 32, 64
# PyTorch's CPU threads before `two_torch_threads` caps them for the module
DEFAULT_THREADS = torch.get_num_threads()
@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The zarr store, the statistics and the shared seeded weights."""
    root = tmp_path_factory.mktemp("fit")
    store = write_era5_store(root / "era5.zarr", tzarr.write_array)
    stats = write_stats(root, tncio)
    conf = fit_conf(store, stats, root / "unused")
    jmodel = jax_load_model(conf)
    x = np.zeros((1, 1, H, W, jmodel.base_input_channels), np.float32)
    variables = _to_numpy(_numpy_variables(jmodel, x, 3))
    return {"root": root, "store": store, "stats": stats, "jmodel": jmodel,
            "variables": variables}


def _read_log(save_loc):
    with open(os.path.join(save_loc, "training_log.csv")) as f:
        return list(csv.reader(f))


def port_trainer(conf):
    exp = build_experiment(conf, device="cpu")
    trainer = load_trainer(conf)(conf, exp["model"], exp["loss"], exp["valid_loss"],
                                 exp["schema"], exp["dataset"], exp["valid_dataset"],
                                 save_loc=conf["save_loc"], normalizer=exp["normalizer"],
                                 device="cpu")
    return trainer


def port_state(trainer, variables, conf):
    trainer.model.load_state_dict(from_jax_variables(variables, conf, device="cpu", fold=False))
    return TrainState.create(trainer.model, trainer.optimizer, ema=trainer.use_ema)


@pytest.fixture(scope="module")
def fits(env):
    """credit_tpu's and the port's 2-epoch fits from the same weights."""
    root, variables = env["root"], env["variables"]
    # (credit_tpu's best/ would be two more orbax saves; the log is the same)
    conf = fit_conf(env["store"], env["stats"], root / "jax", save_best_weights=False)
    jschema, jgrid = JSchema.from_config(conf), JGrid.regular(H, W)
    jnorm = JNormalizer.from_netcdf(jschema, *env["stats"])
    jt = jtrainer.Trainer(conf, env["jmodel"], jlosses.WeightedLoss.from_config(conf, jgrid),
                          jlosses.WeightedLoss.from_config(conf, jgrid, validation=True),
                          jschema, jlocal.load_dataset(conf, jschema, jgrid),
                          jlocal.load_dataset(conf, jschema, jgrid, "valid"),
                          save_loc=conf["save_loc"], normalizer=jnorm)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 spectral=jax.tree_util.tree_map(jnp.asarray,
                                                                 variables["spectral"]),
                                 opt_state=jt.optimizer.init(params),
                                 ema_params=jax.tree_util.tree_map(jnp.copy, params))
    jt.fit(jstate, seed=0)
    tconf = fit_conf(env["store"], env["stats"], root / "port")
    trainer = port_trainer(tconf)
    # on the process's own thread count: the log's near-zero anomaly
    # correlation, compared relatively, reads 1.3e-5 > 1e-5 on two threads
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        state = trainer.fit(port_state(trainer, variables, tconf), seed=0)
    finally:
        torch.set_num_threads(min(DEFAULT_THREADS, 2))
    return {"jax": _read_log(conf["save_loc"]), "port": _read_log(tconf["save_loc"]),
            "trainer": trainer, "state": state, "conf": tconf, "jt": jt}


# --------------------------------------------------------------- metrics
def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("form", ["weighted", "climatology", "ensemble", "unweighted"])
def test_lat_weighted_metrics_match_reference(form):
    """Every named metric within 1e-6 relative of credit_tpu's."""
    names = ["A_L0", "A_L1", "B"]
    t, p = _rand((2, 3, 8, 16, 3), 0), _rand((2, 3, 8, 16, 3), 1) * 0.5
    clim = _rand((8, 16, 3), 2) if form == "climatology" else None
    if form == "unweighted":
        ours, ref = tmetrics.UnWeightedMetrics(names), jmetrics.UnWeightedMetrics(names)
    else:
        ours = tmetrics.LatWeightedMetrics(Grid.regular(8, 16), names,
                                           None if clim is None else torch.from_numpy(clim))
        ref = jmetrics.LatWeightedMetrics(JGrid.regular(8, 16), names,
                                          None if clim is None else jnp.asarray(clim))
    if form == "ensemble":
        pe = _rand((2, 4, 3, 8, 16, 3), 3)
        got = ours.ensemble(torch.from_numpy(t), torch.from_numpy(pe), prefix="v_")
        want = ref.ensemble(jnp.asarray(t), jnp.asarray(pe), prefix="v_")
    else:
        got = ours(torch.from_numpy(t), torch.from_numpy(p))
        want = ref(jnp.asarray(t), jnp.asarray(p))
    assert set(got) == set(want) and len(got) >= 4 * 4
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-6, atol=1e-7, err_msg=k)


def test_ensemble_verification_matches_reference():
    """spread_error, its regional form, the zonal spectrum, the binned
    spread-skill relation and the SHT's rotational and divergent spectra
    (within 1e-5 of each spectrum's largest degree)."""
    t, pe = _rand((2, 1, 8, 16, 2), 4), _rand((2, 5, 1, 8, 16, 2), 5)
    tt, tp, jt_, jp = torch.from_numpy(t), torch.from_numpy(pe), jnp.asarray(t), jnp.asarray(pe)
    for a, b in zip(tmetrics.spread_error(tt, tp), jmetrics.spread_error(jt_, jp)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    lats = np.linspace(80, -80, 8)
    got, want = tmetrics.spread_error_regional(tt, tp, lats), jmetrics.spread_error_regional(
        jt_, jp, lats)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tmetrics.zonal_spectrum(tt[..., 0]).numpy(),
                               np.asarray(jmetrics.zonal_spectrum(jt_[..., 0])), rtol=1e-5,
                               atol=1e-7)
    for a, b in zip(tmetrics.binned_spread_skill(tt, tp, 4), jmetrics.binned_spread_skill(jt_, jp, 4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    got = tmetrics.divergent_rotational_spectra(tt[..., 0], tt[..., 1], Grid.regular(8, 16))
    want = jmetrics.divergent_rotational_spectra(jt_[..., 0], jt_[..., 1], JGrid.regular(8, 16))
    for a, b in zip(got, want):
        assert a.shape == (2, 1, 8)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5 * float(np.abs(np.asarray(b)).max()))


# --------------------------------------------------------------- steps
def _step_parts(env, conf, flen):
    jschema, schema = JSchema.from_config(conf), ChannelSchema.from_config(conf)
    jnorm = JNormalizer.from_netcdf(jschema, *env["stats"])
    tnorm = Normalizer.from_netcdf(schema, *env["stats"])
    jpost = j_build_postblocks(conf, jschema, JGrid.regular(H, W), jnorm)
    tpost = build_postblocks(conf, schema, Grid.regular(H, W), tnorm)
    jm = jmetrics.LatWeightedMetrics(JGrid.regular(H, W), jschema.target_names)
    tm = tmetrics.LatWeightedMetrics(Grid.regular(H, W), schema.target_names)
    data = conf["data"]
    ds = ZarrSourceDataset(schema, data["source"]["ERA5"], data, "ERA5", forecast_len=flen)
    raw = ds.batch([0, 1], flen)
    return jschema, schema, jnorm, tnorm, jpost, tpost, jm, tm, raw


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (what, np.abs(got - want).max() / scale)


def _jstate(variables, optimizer, ema_scale=None):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    ema = None if ema_scale is None else jax.tree_util.tree_map(lambda a: a * ema_scale, params)
    return jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        spectral=jax.tree_util.tree_map(jnp.asarray, variables["spectral"]),
        opt_state=None if optimizer is None else optimizer.init(params), ema_params=ema)


def test_train_step_with_pipeline_matches_reference(env, fits):
    """One step in physical units through the Normalizer, the tracer fixer
    between Denorm and Renorm inside the latitude-weighted loss, the
    metrics and the final state, against credit_tpu's step as its Trainer
    compiled it for the fit (make_train_step with normalizer, postblocks,
    metrics_fn and return_final_state), f32: loss, gradient norm, every
    metric and the final state within 1e-5."""
    conf, jt = fits["conf"], fits["jt"]
    jschema, schema, jnorm, tnorm, jpost, tpost, jm, tm, raw = _step_parts(env, conf, 1)
    assert [type(b).__name__ for b in tpost] == ["Denorm", "TracerFixer", "Renorm"]
    variables = env["variables"]
    _, jmet = jt._train_step(_jstate(variables, jt.optimizer, 1.0),
                             {k: jnp.asarray(v) for k, v in raw.items()}, jax.random.PRNGKey(0))
    model = load_model(conf, device="cpu", sn_state=True)
    model.load_state_dict(from_jax_variables(variables, conf, device="cpu", fold=False))
    opt = make_optimizer(conf, constant(TRAINER["learning_rate"]))
    step = make_train_step(model, WeightedLoss.from_config(conf, Grid.regular(H, W)), opt,
                           schema, forecast_len=1, ema_decay=0.99, normalizer=tnorm,
                           postblocks=tpost, metrics_fn=tm, return_final_state=True,
                           device="cpu")
    state, met = step(TrainState.create(model, opt, ema=True),
                      {k: torch.from_numpy(v) for k, v in raw.items()})
    assert state.step == 1 and met["finite"] == 1.0
    assert set(met) == set(jmet) and len(met) == 3 + 4 * (schema.n_target + 1) + 1
    for k in ("loss", "grad_norm"):
        _close(float(met[k]), float(jmet[k]), 1e-5, k)
    for kind in tmetrics.KINDS:  # each kind against its largest channel
        keys = [k for k in jmet if k == kind or k.startswith(kind + "_")]
        _close([float(met[k]) for k in keys], [float(jmet[k]) for k in keys], 1e-5, kind)
    fx = met["_final_x"]
    assert fx.shape == (2, 1, H, W, schema.n_input) and fx.dtype == torch.float32
    _close(fx.numpy(), np.asarray(jmet["_final_x"]), 1e-5, "_final_x")


def test_eval_step_matches_reference_on_ema(env):
    """A 2-step validation rollout on EMA weights that differ from the
    parameters: loss and metrics within 1e-5 of credit_tpu's
    make_eval_step; the model's own parameters and spectral-norm u/v stay
    bitwise as they were."""
    conf = fit_conf(env["store"], env["stats"], env["root"] / "unused")
    jschema, schema, jnorm, tnorm, jpost, tpost, jm, tm, raw = _step_parts(env, conf, 2)
    variables = env["variables"]
    ema = jax.tree_util.tree_map(lambda a: a * 1.01, variables["params"])
    jstate = _jstate(variables, None, 1.01)
    jeval = jit_lowopt(jtrainer.make_eval_step(
        env["jmodel"], jlosses.WeightedLoss(base="mse"), jschema, forecast_len=2,
        normalizer=jnorm, metrics_fn=jm, postblocks=tuple(jpost)))
    jmet = jeval(jstate, {k: jnp.asarray(v) for k, v in raw.items()}, jax.random.PRNGKey(1))
    model = load_model(conf, device="cpu", sn_state=True)
    model.load_state_dict(from_jax_variables(variables, conf, device="cpu", fold=False))
    tema = from_jax_variables({"params": ema, "spectral": variables["spectral"]}, conf,
                              device="cpu", fold=False)
    state = TrainState(0, model, {}, {k: tema[k] for k, _ in model.named_parameters()})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    evaluate = make_eval_step(model, WeightedLoss(base="mse"), schema, forecast_len=2,
                              normalizer=tnorm, metrics_fn=tm, postblocks=tpost, device="cpu")
    model.train()
    met = evaluate(state, {k: torch.from_numpy(v) for k, v in raw.items()})
    assert not model.training and set(met) == set(jmet)
    _close(float(met["loss"]), float(jmet["loss"]), 1e-5, "loss")
    for kind in tmetrics.KINDS:
        keys = [k for k in jmet if k == kind or k.startswith(kind + "_")]
        _close([float(met[k]) for k in keys], [float(jmet[k]) for k in keys], 1e-5, kind)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # on the model's own weights it scores differently
    plain = make_eval_step(model, WeightedLoss(base="mse"), schema, normalizer=tnorm,
                           device="cpu")(TrainState(0, model, {}), {k: torch.from_numpy(v)
                                                                    for k, v in raw.items()})
    assert float(plain["loss"]) != float(met["loss"])


# --------------------------------------------------------------- fit
def test_fit_log_matches_reference(fits):
    """Two epochs of credit_tpu's Trainer.fit and the port's from the same
    weights and store: the same columns in the same order (64 metric
    columns per split here: 4 kinds x 7 targets + 4 means... x 2), and
    every cell but `seconds` within 1e-5 relative."""
    jlog, tlog = fits["jax"], fits["port"]
    assert tlog[0] == jlog[0] and len(tlog) == len(jlog) == 3
    header = tlog[0]
    assert header[:6] == ["epoch", "train_loss", "valid_loss", "seconds", "lr", "grad_norm"]
    assert sum(h.startswith("train_") for h in header) == 1 + 4 * 8
    assert sum(h.startswith("valid_") for h in header) == 1 + 4 * 8
    for trow, jrow in zip(tlog[1:], jlog[1:]):
        for name, a, b in zip(header, trow, jrow):
            if name == "seconds":
                continue
            a, b = float(a), float(b)
            assert np.isfinite(a) and abs(a - b) <= 1e-5 * max(abs(b), 1e-12), (name, a, b)


def test_fit_writes_checkpoints_and_timings(fits):
    """checkpoint/, backup_checkpoint/, best/, epoch.txt and
    channel_schema.json; the checkpoint holds the final state; each epoch's
    timings cover its batches."""
    save_loc, state, trainer = fits["conf"]["save_loc"], fits["state"], fits["trainer"]
    for name in ("checkpoint", "backup_checkpoint", "best"):
        assert os.path.exists(os.path.join(save_loc, name, Trainer.CHECKPOINT_FILE)), name
    assert open(os.path.join(save_loc, "epoch.txt")).read() == "1"
    assert ChannelSchema.load(save_loc) == trainer.schema
    saved = torch.load(os.path.join(save_loc, "checkpoint", Trainer.CHECKPOINT_FILE),
                       weights_only=True)
    assert saved["step"] == state.step == 4 and saved["opt_state"]["count"] == 4
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    for k, v in state.ema_params.items():
        assert torch.equal(saved["ema_params"][k], v), k
    back = torch.load(os.path.join(save_loc, "backup_checkpoint", Trainer.CHECKPOINT_FILE),
                      weights_only=True)
    assert back["step"] == 2
    assert [e["epoch"] for e in trainer.epoch_timings] == [0, 1]
    for e in trainer.epoch_timings:
        assert len(e["train_ms"]) == 2 and len(e["valid_ms"]) == 1
        assert len(e["copy_ms"]) == len(e["assemble_ms"]) == 3


def test_resume_equals_uninterrupted(env, tmp_path):
    """A 1-epoch fit, then run_training with load_weights for one more
    epoch: the resumed state equals the saved one bitwise before its first
    step, and the run ends bitwise where the uninterrupted 2-epoch fit
    ended, with the same epoch-1 log row (but its seconds). Both on the
    module's two threads (PyTorch's sums, hence the bits, follow the
    thread count; `fits` runs on the process's own)."""
    whole = fit_conf(env["store"], env["stats"], tmp_path / "whole")
    uninterrupted = port_trainer(whole)
    want = uninterrupted.fit(port_state(uninterrupted, env["variables"], whole), seed=0)
    conf = fit_conf(env["store"], env["stats"], tmp_path, num_epoch=1)
    trainer = port_trainer(conf)
    trainer.fit(port_state(trainer, env["variables"], conf), seed=0)
    saved = torch.load(os.path.join(tmp_path, "checkpoint", Trainer.CHECKPOINT_FILE),
                       weights_only=True)
    resume = copy.deepcopy(conf)
    resume["trainer"]["load_weights"] = True
    trainer2, state, start, seed = prepare_training(resume, device="cpu")
    assert start == 1 and seed == 0 and state.step == saved["step"] == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    assert state.opt_state["count"] == 2
    final = run_training(resume, device="cpu")
    assert final.step == want.step == 4
    for k, v in want.model.state_dict().items():
        assert torch.equal(final.model.state_dict()[k], v), k
    for k, v in want.ema_params.items():
        assert torch.equal(final.ema_params[k], v), k
    rows, ref = _read_log(tmp_path), _read_log(whole["save_loc"])
    assert rows[0] == ref[0] and [r[0] for r in rows[1:]] == ["0", "1"]
    drop = ref[0].index("seconds")
    assert [c for i, c in enumerate(rows[-1]) if i != drop] == [
        c for i, c in enumerate(ref[2]) if i != drop]


def test_early_stopping(env, tmp_path):
    """A validation loss that rises after the first epoch stops the fit
    after stopping_patience epochs; best/ keeps the first epoch."""
    conf = fit_conf(env["store"], env["stats"], tmp_path, num_epoch=5, stopping_patience=2,
                    batches_per_epoch=1)
    trainer = port_trainer(conf)
    calls = []

    def rising(state, batch, gen=None):
        calls.append(gen.initial_seed())
        return {"loss": torch.tensor(float(len(calls)))}

    trainer._eval_step = rising
    trainer.fit(port_state(trainer, env["variables"], conf), seed=0)
    rows = _read_log(tmp_path)
    assert [r[0] for r in rows[1:]] == ["0", "1", "2"]
    assert [float(r[2]) for r in rows[1:]] == [1.0, 2.0, 3.0]
    assert len(set(calls)) == 3  # a noise generator per (epoch, batch)
    best = torch.load(os.path.join(tmp_path, "best", Trainer.CHECKPOINT_FILE), weights_only=True)
    assert best["step"] == 1 and open(os.path.join(tmp_path, "epoch.txt")).read() == "2"


def test_rollout_schedule_matches_reference(env, tmp_path, monkeypatch):
    """The scheduled rollout length of each epoch equals credit_tpu's; a
    length below every configured backprop step backprops on its last step."""
    conf = fit_conf(env["store"], env["stats"], tmp_path, num_epoch=8,
                    rollout_schedule={"max_epochs": 8, "min_probability": 0.05},
                    backprop_on_timestep=[3, 4])
    conf["data"]["forecast_len"] = 4
    trainer = port_trainer(conf)
    jt = jtrainer.Trainer(conf, env["jmodel"], jlosses.WeightedLoss(), jlosses.WeightedLoss(),
                          JSchema.from_config(conf), None, save_loc=str(tmp_path),
                          normalizer=None)
    lens = [trainer._scheduled_forecast_len(e, 5) for e in range(8)]
    assert lens == [jt._scheduled_forecast_len(e, 5) for e in range(8)]
    assert len(set(lens)) > 1 and max(lens) <= 4
    seen = {}

    def spy(model, loss, opt, schema, flen, bp, **kw):
        seen[flen] = bp
        return lambda *a: None

    monkeypatch.setattr(ttrainer, "make_train_step", spy)
    for flen in (1, 2, 3, 4):
        trainer._train_step_for(flen)
    assert seen == {1: [0], 2: [1], 3: [2], 4: [2, 3]}


def test_replay_stores_final_states(env, tmp_path):
    """With replay on, each train batch stores its predicted final states
    (physical units, the input layout) under their post-rollout time
    indices; replayed inputs then come from the buffer."""
    conf = fit_conf(env["store"], env["stats"], tmp_path, num_epoch=2,
                    replay={"capacity": 3, "probability": 1.0})
    trainer = port_trainer(conf)
    trainer.fit(port_state(trainer, env["variables"], conf), seed=0)
    items = trainer.replay._items
    assert len(items) == 3
    schema = trainer.schema
    mean = trainer.normalizer.input_mean.numpy()
    for t, state in items:
        assert 1 <= t < len(trainer.dataset) - 1
        assert state.shape == (1, H, W, schema.n_input) and np.isfinite(state).all()
        # physical units: T (index 2..3) near 250 K, not near 0
        assert abs(state[..., 2].mean() - mean[2]) < 0.5 * abs(mean[2])
    rows = _read_log(tmp_path)
    assert len(rows) == 3 and all(np.isfinite(float(r[1])) for r in rows[1:])


# --------------------------------------------------------------- registry, refusals
ALIASES = ["era5", "era5-v2", "era5-gen1", "cam", "gen2", "era5-gen2", "era5-ensemble",
           "era5-ensemble-v2", "universal", "les", "standard-les", "wrf", "standard-wrf",
           "multi-step-wrf", "conus404", "downscaling", "samudra", "no-such-trainer"]


@pytest.mark.parametrize("name", ALIASES)
def test_load_trainer_aliases(name, caplog):
    """Every reference trainer key resolves to the port's Trainer, as in
    credit_tpu; an unknown key warns and falls back."""
    conf = {"trainer": {"type": name}}
    with caplog.at_level(logging.WARNING):
        cls = load_trainer(conf)
    assert cls is Trainer and jtrainer.load_trainer(conf).__name__ == "Trainer"
    assert ("unknown trainer type" in caplog.text) == (name == "no-such-trainer")


@pytest.mark.parametrize("name", ["era5-ic-opt", "ic-opt", "era5-diffusion"])
def test_unported_trainers_raise(name):
    """The IC-optimisation keys resolve to the port's
    optimize_initial_condition, as credit_tpu's resolve to its own (its
    parity: tests/test_torch_port_icopt_ptype.py); era5-diffusion resolves
    to the port's diffusion trainer (its fit against credit_tpu's:
    tests/test_torch_port_diffusion.py)."""
    cls = load_trainer({"trainer": {"type": name}})
    if name == "era5-diffusion":
        from credit_torch.trainers.diffusion import DiffusionTrainer

        assert cls is DiffusionTrainer and issubclass(cls, Trainer)
        assert jtrainer.load_trainer({"trainer": {"type": name}}).__name__ == "DiffusionTrainer"
        return
    from credit_torch.trainers.ic_optimization import optimize_initial_condition

    assert cls is optimize_initial_condition
    assert jtrainer.load_trainer({"trainer": {"type": name}}).__name__ == (
        "optimize_initial_condition")


@pytest.mark.parametrize("option", ["parallelism", "ensemble", "sn_external", "preblocks",
                                    "grad_accum", "ring_crps", "downscaling"])
def test_trainer_refuses_unported_options(env, tmp_path, option):
    """Ensembles, sn_external and grad_accum_every, once refused, now
    build the trainer (their parity with credit_tpu:
    tests/test_torch_port_ensemble.py and ..._ensemble_fit.py), and so do a
    `regrid` preblock, refused until ops/regrid.py (its fit against
    credit_tpu's: tests/test_torch_port_obs.py), and the `ring-crps` loss
    (parallel/ring_crps.py; its dense form outside a process group,
    tests/test_torch_port_parallel.py). Parallelism is ported: in one
    process a mesh of 2 raises credit_tpu's ValueError (the mesh against
    the device count; the multi-process runs:
    tests/test_torch_port_parallel_fit.py)."""
    conf = fit_conf(env["store"], env["stats"], tmp_path)
    t = conf["trainer"]
    if option == "parallelism":
        t["parallelism"] = {"data": 2, "tensor": 1, "domain": 1}
    elif option == "ensemble":
        t["ensemble_size"] = 3
        conf["loss"]["validation_loss"] = "almost-fair-crps"
    elif option == "sn_external":
        t["sn_external"] = True
    elif option == "preblocks":
        grid = Grid.regular(H, W)
        conf["preblocks"] = [{"type": "regrid", "src_lat": grid.lat[::-1].tolist(),
                              "src_lon": grid.lon.tolist()}]
    elif option == "grad_accum":
        t["grad_accum_every"] = 2
    elif option == "ring_crps":
        t["ensemble_size"] = 2
        conf["loss"]["training_loss"] = "ring-crps"
    else:
        conf["data"]["datasets"] = {}
    if option == "preblocks":
        assert isinstance(port_trainer(conf), Trainer)
        return
    if option == "downscaling":  # DownscalingLoss, refused until ported
        trainer = port_trainer(conf)
        from credit_torch.losses import DownscalingLoss

        assert isinstance(trainer.loss_fn, DownscalingLoss)
        assert trainer.loss_fn.lat_weights is None
        assert trainer.valid_loss_fn.base_name == "mae"
        return
    if option == "ring_crps":
        trainer = port_trainer(conf)
        assert trainer.loss_fn.base_name == "ring-crps" and trainer.loss_fn.is_ensemble
        return
    if option == "parallelism":
        with pytest.raises(ValueError, match="does not fit the visible devices"):
            port_trainer(conf)
        return
    if option in ("ensemble", "sn_external", "grad_accum"):
        trainer = port_trainer(conf)
        assert trainer.ensemble_size == (3 if option == "ensemble" else 1)
        assert trainer.valid_ensemble_size == (3 if option == "ensemble" else 1)
        assert trainer.sn_external == (option == "sn_external")
        assert isinstance(trainer.optimizer, ttrainer.MultiSteps) == (option == "grad_accum")
        return
    raise AssertionError(option)


def test_run_training_refuses_the_cpu_unless_asked(env, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = fit_conf(env["store"], env["stats"], tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_training(conf)
    assert not os.listdir(tmp_path)


# --------------------------------------------------------------- preflight
def test_preflight_matches_reference(env, caplog):
    """The host RAM estimate equals credit_tpu's; the first-step watchdog
    warns past its timeout (naming the kernel build), never raises, and
    returns the step's value; the device memory probe needs CUDA."""
    conf = fit_conf(env["store"], env["stats"], env["root"] / "unused")
    trainer = port_trainer(conf)
    jschema = JSchema.from_config(conf)
    jds = jlocal.load_dataset(conf, jschema, JGrid.regular(H, W))
    assert tpreflight.estimate_batch_ram(trainer.dataset, 2, 1) == \
        jpreflight.estimate_batch_ram(jds, 2, 1)
    import time

    with caplog.at_level(logging.WARNING):
        out = tpreflight.first_batch_watchdog(lambda: (time.sleep(0.3), 7)[1], timeout_s=0.05,
                                              name="first train step")
    assert out == 7 and "nvcc" in caplog.text
    state = TrainState.create(trainer.model, trainer.optimizer)
    assert tpreflight.estimate_train_memory(None, state, None) is None

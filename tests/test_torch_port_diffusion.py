"""Parity of the port's Gaussian diffusion and `era5-diffusion` trainer
with credit_tpu: the beta schedules, the forward noising, the three
objectives' targets and their inversion, the training loss and a DDIM
sample of a crossformer-diffusion backbone at credit_tpu's own
jax.random draws (replayed into the port's entry points that take the
draws), and one `Trainer.fit` epoch on the zarr store.

The same numpy weights and inputs go to both packages on the CPU in f32;
credit_tpu's programs run under jax.jit, the port's kernels as their plain
PyTorch versions.
"""

import copy
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import TINY_MODEL_CONF
from credit_tpu import diffusion as jdiff
from credit_tpu import losses as jlosses
from credit_tpu.data import local as jlocal
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.data.normalize import Normalizer as JNormalizer
from credit_tpu.grid import Grid as JGrid
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.trainers import trainer as jtrainer
from credit_torch import diffusion as tdiff
from credit_torch.applications import build_experiment
from credit_torch.convert_jax import from_jax_variables
from credit_torch.data import zarrlite as tzarr
from credit_torch.models import load_model
from credit_torch.trainers.diffusion import DiffusionTrainer
from credit_torch.trainers.trainer import TrainState, load_trainer
from credit_torch.utils import ncio as tncio
from torch_port_fixtures import fit_conf, jit_lowopt, write_era5_store, write_stats
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)
from tests.test_torch_port_model import _numpy_variables, _to_numpy

H, W = 32, 64
T = 100  # diffusion steps of the tests (credit_tpu's default is 1000)


@pytest.mark.parametrize("name", sorted(tdiff.SCHEDULES))
def test_beta_schedules_match_reference(name):
    """float64 numpy on both sides: bitwise."""
    for steps in (10, 1000):
        np.testing.assert_array_equal(tdiff.SCHEDULES[name](steps),
                                      jdiff._SCHEDULES[name](steps))


@pytest.mark.parametrize("objective", tdiff.OBJECTIVES)
def test_noising_targets_and_inversion_match_reference(objective):
    """q_sample, the objective's target and (x0, eps) from a prediction,
    f32 at the same (t, noise): 1e-6 of max |ref|."""
    rng = np.random.default_rng(0)
    y0, noise, pred = (rng.standard_normal((3, 1, 4, 8, 5)).astype(np.float32)
                       for _ in range(3))
    t = np.array([0, 57, T - 1])
    jd = jdiff.GaussianDiffusion(None, timesteps=T, objective=objective)
    td = tdiff.GaussianDiffusion(None, timesteps=T, objective=objective)
    tt = torch.from_numpy(t)
    y0t, nt, pt = map(torch.from_numpy, (y0, noise, pred))
    jt_ = jnp.asarray(t)
    pairs = [(td.q_sample(y0t, tt, nt), jd.q_sample(y0, jt_, noise)),
             (td.target(y0t, tt, nt), jd.target(y0, jt_, noise)),
             *zip(td.to_x0_eps(y0t, tt, pt), jd._to_x0_eps(y0, jt_, pred))]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(td.alphas_cumprod.numpy(), np.asarray(jd.alphas_cumprod))


CF = {**copy.deepcopy(TINY_MODEL_CONF["model"]), "type": "crossformer-diffusion"}


@pytest.fixture(scope="module")
def backbone():
    """A tiny crossformer-diffusion on both sides with the same weights,
    a condition and a target."""
    conf = {"model": CF}
    jmodel = jax_load_model(conf)
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((2, 1, H, W, jmodel.base_input_channels)).astype(np.float32)
    y0 = rng.standard_normal((2, 1, H, W, jmodel.base_output_channels)).astype(np.float32)
    variables = _to_numpy(_numpy_variables(jmodel, cond, 2))
    port = load_model(conf, device="cpu")
    port.load_state_dict(from_jax_variables(variables, conf, device="cpu"))
    return jmodel, variables, port, cond, y0


def _jax_gd(jmodel, **kw):
    return jdiff.GaussianDiffusion(
        lambda v, c, y, t: jmodel.apply(v, c, y_noisy=y, t_frac=t), timesteps=T, **kw)


def _port_gd(port, **kw):
    return tdiff.GaussianDiffusion(lambda c, y, t: port(c, y_noisy=y, t_frac=t),
                                   timesteps=T, **kw)


def _train_draws(key, shape):
    """credit_tpu's draws inside GaussianDiffusion.loss(key)."""
    kt, kn = jax.random.split(key)
    t = jax.random.randint(kt, (shape[0],), 0, T)
    return (torch.from_numpy(np.asarray(t).astype(np.int64)),
            torch.from_numpy(np.asarray(jax.random.normal(kn, shape, jnp.float32))))


def _sample_draws(key, shape, steps):
    """credit_tpu's draws inside GaussianDiffusion.sample(key): the start,
    then one per DDIM step."""
    key, sub = jax.random.split(key)
    y = np.asarray(jax.random.normal(sub, shape))
    noises = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        noises.append(torch.from_numpy(np.asarray(jax.random.normal(sub, shape, jnp.float32))))
    return torch.from_numpy(y), noises


@pytest.mark.parametrize("objective", tdiff.OBJECTIVES)
def test_loss_at_replayed_draws_matches_reference(backbone, objective):
    """The training loss of the backbone at credit_tpu's (t, noise), f32:
    1e-5 relative."""
    jmodel, variables, port, cond, y0 = backbone
    key = jax.random.PRNGKey(7)
    ref = jit_lowopt(lambda v: _jax_gd(jmodel, objective=objective).loss(v, cond, y0, key))(
        variables)
    t, noise = _train_draws(key, y0.shape)
    with torch.no_grad():
        got = _port_gd(port, objective=objective).loss_at(
            torch.from_numpy(cond), torch.from_numpy(y0), t, noise)
    assert abs(got.item() - float(ref)) <= 1e-5 * abs(float(ref))


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_at_replayed_draws_matches_reference(backbone, eta):
    """Four DDIM steps (pred_v, sigmoid schedule) from credit_tpu's start
    and per-step noise, f32: 1e-4 of max |ref| (four backbone calls, each
    within ~1e-6)."""
    jmodel, variables, port, cond, _ = backbone
    shape = (2, 1, H, W, jmodel.base_output_channels)
    key = jax.random.PRNGKey(11)
    ref = jit_lowopt(lambda v: _jax_gd(jmodel, sampling_timesteps=4, ddim_eta=eta).sample(
        v, cond, key, shape))(variables)
    y, noises = _sample_draws(key, shape, 4)
    with torch.no_grad():
        got = _port_gd(port, sampling_timesteps=4, ddim_eta=eta).sample_from(
            torch.from_numpy(cond), y, noises)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    # the port's own draws: finite, of the shape, from the generator
    gd = _port_gd(port, sampling_timesteps=2, ddim_eta=eta)
    with torch.no_grad():
        a = gd.sample(torch.from_numpy(cond), shape, torch.Generator().manual_seed(0))
        b = gd.sample(torch.from_numpy(cond), shape, torch.Generator().manual_seed(0))
    assert a.shape == shape and torch.isfinite(a).all() and torch.equal(a, b)


def _read_log(save_loc):
    with open(os.path.join(save_loc, "training_log.csv")) as f:
        return list(csv.reader(f))


def test_diffusion_fit_matches_reference(tmp_path):
    """One epoch (2 training batches of 2, 1 validation batch sampled by
    DDIM in 3 steps from the EMA weights) of credit_tpu's era5-diffusion
    Trainer.fit and the port's from the same weights on the zarr store,
    the port's draws replaced by credit_tpu's (its fit's key chain): every
    training_log.csv cell but `seconds` within 1e-5 relative."""
    store = write_era5_store(tmp_path / "era5.zarr", tzarr.write_array)
    stats = write_stats(tmp_path, tncio)

    def conf_for(save_loc):
        conf = fit_conf(store, stats, save_loc, num_epoch=1, replay=None)
        conf["model"] = {**CF}
        conf["trainer"]["type"] = "era5-diffusion"
        conf["diffusion"] = {"timesteps": T, "sampling_timesteps": 3}
        return conf

    conf = conf_for(tmp_path / "jax")
    jmodel = jax_load_model(conf)
    jschema, jgrid = JSchema.from_config(conf), JGrid.regular(H, W)
    x = np.zeros((1, 1, H, W, jschema.n_input), np.float32)
    variables = _to_numpy(_numpy_variables(jmodel, x, 3))
    jcls = jtrainer.load_trainer(conf)
    jt = jcls(conf, jmodel, jlosses.WeightedLoss.from_config(conf, jgrid),
              jlosses.WeightedLoss.from_config(conf, jgrid, validation=True), jschema,
              jlocal.load_dataset(conf, jschema, jgrid),
              jlocal.load_dataset(conf, jschema, jgrid, "valid"), save_loc=conf["save_loc"],
              normalizer=JNormalizer.from_netcdf(jschema, *stats))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jt.fit(jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        spectral=jax.tree_util.tree_map(jnp.asarray, variables["spectral"]),
        opt_state=jt.optimizer.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params)), seed=0)

    tconf = conf_for(tmp_path / "port")
    exp = build_experiment(tconf, device="cpu")
    trainer = load_trainer(tconf)(tconf, exp["model"], exp["loss"], exp["valid_loss"],
                                  exp["schema"], exp["dataset"], exp["valid_dataset"],
                                  save_loc=tconf["save_loc"], normalizer=exp["normalizer"],
                                  device="cpu")
    assert isinstance(trainer, DiffusionTrainer)
    # credit_tpu's fit: rng = PRNGKey(seed), split once a training batch;
    # validation keys from fold_in(PRNGKey(seed + 0x5EED), epoch), split
    # once a batch
    train_keys, rng = [], jax.random.PRNGKey(0)
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        train_keys.append(sub)
    _, ek = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0x5EED), 0))
    keys = iter(train_keys)
    trainer.gd.train_draws = lambda y0, generator=None: _train_draws(next(keys), y0.shape)
    trainer.gd.sample_draws = lambda shape, generator=None, device=None: _sample_draws(
        ek, shape, 3)
    model = trainer.model
    model.load_state_dict(from_jax_variables(variables, tconf, device="cpu", fold=False))
    trainer.fit(TrainState.create(model, trainer.optimizer, ema=True), seed=0)
    jlog, tlog = _read_log(conf["save_loc"]), _read_log(tconf["save_loc"])
    assert tlog[0] == jlog[0] and len(tlog) == len(jlog) == 2
    assert tlog[0] == ["epoch", "train_loss", "valid_loss", "seconds", "lr", "grad_norm"]
    for name, a, b in zip(tlog[0], tlog[1], jlog[1]):
        if name != "seconds":
            a, b = float(a), float(b)
            assert np.isfinite(a) and abs(a - b) <= 1e-5 * max(abs(b), 1e-12), (name, a, b)
    with pytest.raises(StopIteration):
        next(keys)

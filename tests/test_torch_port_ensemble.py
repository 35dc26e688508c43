"""Parity of the port's ensemble (CRPS) training pieces with credit_tpu's:
the CRPS family, the spectral, power and covmse losses, the noise-injection
CrossFormer (`crossformer-ensemble`), `grad_accum_every`'s optimizer
(optax.MultiSteps) and the ensemble eval step; the fit, the train steps and
`sn_external` are in tests/test_torch_port_ensemble_fit.py.

credit_tpu draws its noise from flax's 'noise' stream, which nothing can
inject; these tests read the draws it makes for a key (the latent as the
input of each SDL's `noise_transform`, intercepted; the pixels from the
`captured` collection) and replay them in the port's forwards, in the
order credit_tpu makes them. The same numpy weights go to both packages,
f32 on the CPU: the JAX model takes its XLA composition, the port's
kernels their plain versions.
"""

import copy
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from credit_tpu import losses as jlosses
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.data.normalize import Normalizer as JNormalizer
from credit_tpu.grid import Grid as JGrid
from credit_tpu.metrics import LatWeightedMetrics as JMetrics
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.models.spectral_utils import converge_spectral
from credit_tpu.native import fastload as jfastload
from credit_tpu.postblock import build_postblocks as j_build_postblocks
from credit_tpu.trainers import trainer as jtrainer
from credit_torch import losses as tlosses
from credit_torch.applications import build_experiment
from credit_torch.convert_jax import from_jax_variables
from credit_torch.data import zarrlite as tzarr
from credit_torch.models import load_model
from credit_torch.trainers import trainer as ttrainer
from credit_torch.trainers.scheduler import constant
from credit_torch.trainers.trainer import TrainState, load_trainer
from credit_torch.utils import ncio as tncio
from torch_port_fixtures import fit_conf, write_era5_store, write_stats
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

H, W = 32, 64
E = 3
LR = 1e-3


@pytest.fixture(autouse=True)
def python_reference_reader(monkeypatch):
    """credit_tpu's zarr reader on its Python path: its native library
    builds into one path shared by every test worker."""
    monkeypatch.setattr(jfastload, "available", lambda: False)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err)


def _metric_close(name, got, want, tol=1e-5):
    """A metric or log cell: relative, but the anomaly correlations (acc*)
    absolute, since they sit near 0 on random fields."""
    got, want = float(got), float(want)
    scale = 1.0 if "acc" in name else max(abs(want), 1e-12)
    assert np.isfinite(got) and abs(got - want) <= tol * scale, (name, got, want)


# --------------------------------------------------------------- losses
@pytest.mark.parametrize("m", [2, 3, 5])
def test_crps_losses_match_reference(m):
    """kcrps (fair and biased), almost_fair_crps (alpha 1 and 0.9) and
    crps_ensemble over m members: each field within 1e-6 of credit_tpu's,
    relative to its largest value."""
    t, p = _rand((2, 1, 6, 8, 3), 0), _rand((2, m, 1, 6, 8, 3), m)
    tt, tp, jt, jp = torch.from_numpy(t), torch.from_numpy(p), jnp.asarray(t), jnp.asarray(p)
    for name, ours, ref in [
            ("kcrps", tlosses.kcrps(tt, tp), jlosses.kcrps(jt, jp)),
            ("kcrps biased", tlosses.kcrps(tt, tp, biased=True), jlosses.kcrps(jt, jp, biased=True)),
            ("almost fair", tlosses.almost_fair_crps(tt, tp), jlosses.almost_fair_crps(jt, jp)),
            ("almost fair 0.9", tlosses.almost_fair_crps(tt, tp, alpha=0.9),
             jlosses.almost_fair_crps(jt, jp, alpha=0.9)),
            ("crps_ensemble", tlosses.crps_ensemble(tt, tp), jlosses.crps_ensemble(jt, jp))]:
        assert ours.shape == t.shape, name
        _close(ours.numpy(), ref, 1e-6, name)
    assert tlosses.load_loss("KCRPS") is tlosses.kcrps


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "lat_weighted"])
def test_spectral_losses_match_reference(weighted):
    """spectral and power (rfft over longitude, wavenumbers from 2) and
    covmse, with and without latitude weights: within 1e-6 relative."""
    t, p = _rand((2, 1, 6, 16, 3), 1), _rand((2, 1, 6, 16, 3), 2)
    lat = np.random.default_rng(3).uniform(0.2, 1.5, 6).astype(np.float32) if weighted else None
    tt, tp, jt, jp = torch.from_numpy(t), torch.from_numpy(p), jnp.asarray(t), jnp.asarray(p)
    tl = None if lat is None else torch.from_numpy(lat)
    jl = None if lat is None else jnp.asarray(lat)
    for name, ours, ref in [
            ("spectral", tlosses.spectral_loss(tt, tp, tl, 2), jlosses.spectral_loss(jt, jp, jl, 2)),
            ("power", tlosses.power_loss(tt, tp, tl, 2), jlosses.power_loss(jt, jp, jl, 2)),
            ("covmse", tlosses.covariance_weighted_mse(tt, tp),
             jlosses.covariance_weighted_mse(jt, jp))]:
        _close(ours.numpy(), ref, 1e-6, name)


@pytest.mark.parametrize("base", ["almost-fair-crps", "KCRPS", "mse", "covmse"])
def test_weighted_loss_terms_match_reference(base):
    """WeightedLoss with latitude and variable weights and both spectral
    terms: the CRPS bases on (B, E, ...) members (the terms on the member
    mean), the rest on one prediction; within 1e-6 relative. Validation
    drops the terms."""
    ens = tlosses.is_crps_loss(base)
    t = _rand((2, 1, 6, 16, 3), 4)
    p = _rand((2, 3, 1, 6, 16, 3) if ens else (2, 1, 6, 16, 3), 5)
    kw = dict(lat_weights=np.random.default_rng(6).uniform(0.2, 1.5, 6).astype(np.float32),
              var_weights=np.asarray([1.0, 0.5, 2.0], np.float32), spectral_lambda=0.1,
              power_lambda=0.05, wavenum_init=2)
    for validation in (False, True):
        ours = tlosses.WeightedLoss(base=base, validation=validation, **kw)
        ref = jlosses.WeightedLoss(base=base, validation=validation, **kw)
        assert ours.is_ensemble == ref.is_ensemble == ens
        _close(float(ours(torch.from_numpy(t), torch.from_numpy(p))),
               float(ref(jnp.asarray(t), jnp.asarray(p))), 1e-6, (base, validation))


def test_crps_gradient_through_the_tracer_fixer(env, tmp_path):
    """The almost-fair CRPS with latitude weights behind the tracer fixer
    (Denorm, the PRECIP clip, Renorm), as the ensemble step scores each
    member. Its gradient with respect to the members is a sum of signs:
    lw / N * (sign(x_e - t) / m - sum_j sign(x_e - x_j) / (m (m - 1))) on
    the fixed members x, 0 where the clip holds. The port's autograd and
    credit_tpu's jax.grad run op by op both equal this float64 sum within
    1e-6 of its largest value. credit_tpu's jax.grad under jax.jit does
    not on XLA:CPU: it moves 0.88 of the elements here, by up to half the
    largest value (0.49), and the same program without the fixer is exact
    again. The 6 member pairs within 1e-5 of a tie (SP's Denorm/Renorm
    rounds to ~8e-6) touch 12 elements, so this is not the CRPS kinks:
    credit_tpu's jitted train step
    takes a wrong gradient for this pipeline on the CPU, and
    tests/test_torch_port_ensemble_fit.py leaves the fixer out of the
    steps it holds against it."""
    conf = ens_conf(env, tmp_path)
    conf["loss"].update(use_spectral_loss=False, use_power_loss=False)
    trainer = port_trainer(conf)
    jschema, jgrid = JSchema.from_config(conf), JGrid.regular(H, W)
    jnorm = JNormalizer.from_netcdf(jschema, *env["stats"])
    jpost = j_build_postblocks(conf, jschema, jgrid, jnorm)
    jloss = jlosses.WeightedLoss.from_config(conf, jgrid)
    assert [type(b).__name__ for b in jpost] == ["Denorm", "TracerFixer", "Renorm"]
    c = len(trainer.schema.target_names)
    rng = np.random.default_rng(12)
    base = rng.standard_normal((2, 1, 1, H, W, c))
    y = (base + 0.05 * rng.standard_normal((2, E, 1, H, W, c))).astype(np.float32)
    y = y.reshape(2 * E, 1, H, W, c)
    t = rng.standard_normal((2, 1, H, W, c)).astype(np.float32)
    x = np.zeros((2 * E, 1, H, W, env["jmodel"].base_input_channels), np.float32)
    jx, jt_ = jnp.asarray(x), jnp.asarray(t)

    def jax_loss(y, post=True):
        for b in (jpost if post else ()):
            y = b(y, jx)
        return jloss(jt_, y.reshape(2, E, *y.shape[1:]))

    ty = torch.from_numpy(y).requires_grad_()
    members = ty
    for b in trainer.train_postblocks:
        members = b(members, torch.from_numpy(x))
    trainer.loss_fn(torch.from_numpy(t), members.reshape(2, E, *y.shape[1:])).backward()
    with jax.disable_jit():
        eager = np.asarray(jax.grad(jax_loss)(jnp.asarray(y)))
    jitted = np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(y)))

    xm = members.detach().numpy().astype(np.float64).reshape(2, E, 1, H, W, c)
    held = np.zeros(xm.shape, bool)  # the clip holds: the member sits at the fixed bound
    precip = trainer.schema.target_names.index("PRECIP")
    held[..., precip] = xm[..., precip] == xm[..., precip].min()
    want = np.sign(xm - t[:, None]) / E
    for j in range(E):
        want -= np.sign(xm - xm[:, j:j + 1]) / (E * (E - 1))
    lw = np.asarray(jloss.lat_weights, np.float64)
    want = np.where(held, 0.0, want * lw[:, None, None] / t.size).reshape(y.shape)
    scale = np.abs(want).max()
    for name, got in [("port", ty.grad.numpy()), ("credit_tpu op by op", eager)]:
        assert np.abs(got - want).max() <= 1e-6 * scale, name
    moved = np.abs(jitted - want) > 1e-6 * scale
    assert moved.mean() > 0.5 and np.abs(jitted - want).max() > 0.1 * scale
    near = sum(int((np.abs(xm[:, i] - xm[:, j]) <= 1e-5)[~held[:, i] & ~held[:, j]].sum())
               for i in range(E) for j in range(i + 1, E))
    assert moved.sum() > 100 * max(2 * near, 1), (moved.sum(), near)
    plain = np.asarray(jax.jit(jax.grad(lambda y: jax_loss(y, post=False)))(jnp.asarray(y)))
    with jax.disable_jit():
        plain_eager = np.asarray(jax.grad(lambda y: jax_loss(y, post=False))(jnp.asarray(y)))
    assert np.abs(plain - plain_eager).max() <= 1e-6 * np.abs(plain_eager).max()


# --------------------------------------------------------------- noise replay
def _numpy_variables(model, x, seed: int):
    """The JAX model's parameters and spectral state drawn with numpy
    (kernels he_uniform, scales and modulations near 1, u/v converged,
    the rest small normals), without its `captured` collection."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda x: model.init({"params": key, "noise": key}, x),
                            jnp.asarray(x))

    def draw(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            lim = np.sqrt(6.0 / np.prod(s.shape[:-1]))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        if "scale" in name or "modulation" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "'u'" in name or "'v'" in name:
            v = rng.standard_normal(s.shape)
            return (v / np.linalg.norm(v)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    tree = {k: v for k, v in shapes.items() if k in ("params", "spectral")}
    out = converge_spectral(jax.tree_util.tree_map_with_path(draw, tree))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def _noise_drawer(jmodel, variables):
    """draw(key, shape) -> the noise credit_tpu's model draws from `key`
    for an input of `shape`: {"latent": ..., <layer>: pixel noise}."""
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    @jax.jit
    def capture(key, x):
        latent = []

        def intercept(next_fun, args, kwargs, ctx):
            if ctx.module.name == "noise_transform" and ctx.method_name == "__call__":
                latent.append(args[0])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(intercept):
            _, mut = jmodel.apply(jvars, x, train=True, rngs={"noise": key},
                                  mutable=["captured", "spectral"])
        return latent[0], {k: v["pixel"][-1] for k, v in mut["captured"].items()}

    def draw(key, shape):
        latent, pixels = capture(key, jnp.zeros(shape, jnp.float32))
        out = {"latent": latent, **pixels}
        return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}

    return draw


def replay(model, draws):
    """Make the port's model take its noise from `draws`, one dict per
    forward in call order (the generator it is given is not used)."""
    forward, queue = type(model).forward, list(draws)

    def replayed(x, noise=None, generator=None):
        return forward(model, x, noise=queue.pop(0))

    model.forward = replayed
    return queue


def _step_key(key):
    """The noise key of rollout step 0 inside credit_tpu's train and eval
    steps, for the key the step is given."""
    return jax.random.split(key)[1]


def ens_conf(env, save_loc, **trainer):
    """The tiny fit's config (tests/torch_port_fixtures.py) as an ensemble
    CRPS fit: crossformer-ensemble, E = 3 members of 2 samples, the
    almost-fair CRPS with latitude weights and both spectral terms, KCRPS
    validation, grad_accum_every 2, sn_external."""
    kw = dict(ensemble_size=E, grad_accum_every=2, sn_external=True, learning_rate=LR)
    conf = fit_conf(env["store"], env["stats"], save_loc, **{**kw, **trainer})
    conf["model"]["type"] = "crossformer-ensemble"
    conf["loss"] = {"training_loss": "almost-fair-crps", "validation_loss": "KCRPS",
                    "use_latitude_weights": True, "use_spectral_loss": True,
                    "use_power_loss": True, "spectral_lambda_reg": 0.01,
                    "spectral_wavenum_init": 2}
    return conf


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("ens")
    store = write_era5_store(root / "era5.zarr", tzarr.write_array)
    stats = write_stats(root, tncio)
    env = {"root": root, "store": store, "stats": stats}
    conf = ens_conf(env, root / "unused")
    jmodel = jax_load_model(conf)
    x = np.zeros((1, 1, H, W, jmodel.base_input_channels), np.float32)
    variables = _numpy_variables(jmodel, x, 3)
    # every batch of 2 x 3 members and of 3 x 2 has this input shape: one
    # compile of the noise capture
    return {**env, "conf": conf, "jmodel": jmodel, "variables": variables,
            "draw": _noise_drawer(jmodel, variables),
            "shape": (2 * E, 1, H, W, jmodel.base_input_channels)}


def _jstate(variables, optimizer, ema=True):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        spectral=jax.tree_util.tree_map(jnp.asarray, variables["spectral"]),
        opt_state=optimizer.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params) if ema else None)


def _port_tree(jstate, conf, which="params"):
    """A JAX state's parameters (or EMA) and spectral u/v by the port's
    names."""
    tree = {"params": getattr(jstate, which), "spectral": jstate.spectral}
    return from_jax_variables(jax.device_get(tree), conf, device="cpu", fold=False)


def port_trainer(conf):
    exp = build_experiment(conf, device="cpu")
    return load_trainer(conf)(conf, exp["model"], exp["loss"], exp["valid_loss"], exp["schema"],
                              exp["dataset"], exp["valid_dataset"], save_loc=conf["save_loc"],
                              normalizer=exp["normalizer"], device="cpu")


def port_state(trainer, variables, conf):
    trainer.model.load_state_dict(from_jax_variables(variables, conf, device="cpu", fold=False))
    return TrainState.create(trainer.model, trainer.optimizer, ema=trainer.use_ema)


def _read_log(save_loc):
    with open(os.path.join(save_loc, "training_log.csv")) as f:
        return list(csv.reader(f))


# --------------------------------------------------------------- model
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_ensemble_forward_matches_reference(env, dtype, tol):
    """crossformer-ensemble's forward with credit_tpu's latent and pixel
    noise injected: 1e-5 relative in f32; in bf16 both sides round the
    activations at every layer, in other orders (3e-2 relative). Other
    noise moves the output (the factors are not zero)."""
    conf = copy.deepcopy(env["conf"])
    conf["model"]["compute_dtype"] = dtype
    jmodel = jax_load_model(conf) if dtype != "float32" else env["jmodel"]
    x = _rand((2 * E, 1, H, W, jmodel.base_input_channels), 7)
    key = jax.random.PRNGKey(11)
    jvars = jax.tree_util.tree_map(jnp.asarray, env["variables"])
    ref = np.asarray(jax.jit(lambda x: jmodel.apply(jvars, x, rngs={"noise": key}))(
        jnp.asarray(x)), np.float32)
    draw = env["draw"] if dtype == "float32" else _noise_drawer(jmodel, env["variables"])
    model = load_model(conf, device="cpu")
    model.load_state_dict(from_jax_variables(env["variables"], conf, device="cpu"))
    with torch.no_grad():
        out = model(torch.from_numpy(x), noise=draw(key, x.shape)).float().numpy()
        other = model(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    _close(out, ref, tol, dtype)
    assert np.abs(other.float().numpy() - out).max() > 10 * tol * np.abs(ref).max()


def test_multisteps_matches_optax():
    """The port's MultiSteps(AdamW) against credit_tpu's make_optimizer
    (optax.MultiSteps over clip_by_global_norm and adamw) on the same
    gradients, 2 micro-steps an update over 6 calls, one of them all zeros
    (what the NaN guard hands it) and one past the clip: no update and the
    inner state untouched between updates, the mean of the micro-gradients
    clipped and applied on every second call; the parameters, moments and
    running mean within 1e-6 relative at each call."""
    conf = {"trainer": {"grad_accum_every": 2, "grad_max_norm": 1.0, "weight_decay": 0.01}}
    jopt = jtrainer.make_optimizer(conf, lambda _: 1e-3)
    topt = ttrainer.make_optimizer(conf, constant(1e-3))
    assert isinstance(topt, ttrainer.MultiSteps) and topt.every == 2
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: _rand(v, i) for i, (k, v) in enumerate(shapes.items())}
    jp, jstate = dict(params), jopt.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    for i, scale in enumerate([0.1, 0.2, 0.0, 0.3, 5.0, 0.1]):
        g = {k: _rand(v, 10 * i + j, scale) for j, (k, v) in enumerate(shapes.items())}
        upd, jstate = jopt.update(g, jstate, jp)
        jp = {k: np.asarray(jp[k] + upd[k]) for k in jp}
        names = list(tstate["mu"])
        tupd, tstate = topt.update([torch.from_numpy(g[k]) for k in names], tstate,
                                   [tp[k] for k in names])
        assert (tupd is None) == (i % 2 == 0)
        if tupd is not None:
            torch._foreach_add_([tp[k] for k in names], tupd)
        assert tstate["mini_step"] == int(jstate.mini_step) == (i + 1) % 2
        assert tstate["count"] == int(jstate.gradient_step) == (i + 1) // 2
        adam = jstate.inner_opt_state[1][0]
        for k in names:
            for got, want in [(tp[k], jp[k]), (tstate["acc"][k], jstate.acc_grads[k]),
                              (tstate["mu"][k], adam.mu[k]), (tstate["nu"][k], adam.nu[k])]:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12,
                                           err_msg=f"call {i}, {k}")


def test_crps_validation_step_takes_two_members(env, tmp_path):
    """With one training member and a CRPS validation loss the trainer
    validates on max(E, 2) = 2 members (1 under MSE); its eval step on EMA
    weights matches credit_tpu's make_eval_step at 2 members of 3 samples:
    the loss and every metric within 1e-5 relative."""
    conf = ens_conf(env, tmp_path, ensemble_size=1)
    trainer = port_trainer(conf)
    assert trainer.valid_ensemble_size == 2
    mse = ens_conf(env, tmp_path, ensemble_size=1)
    mse["loss"]["validation_loss"] = "mse"
    assert port_trainer(mse).valid_ensemble_size == 1
    jschema = JSchema.from_config(conf)
    jgrid = JGrid.regular(H, W)
    jnorm = JNormalizer.from_netcdf(jschema, *env["stats"])
    jeval = jax.jit(jtrainer.make_eval_step(
        env["jmodel"], jlosses.WeightedLoss.from_config(conf, jgrid, validation=True), jschema,
        normalizer=jnorm, ensemble_size=2, metrics_fn=JMetrics(jgrid, jschema.target_names),
        postblocks=tuple(j_build_postblocks(conf, jschema, jgrid, jnorm))))
    raw = trainer.valid_dataset.batch([0, 1, 2], 1)
    variables = env["variables"]
    jstate = _jstate(variables, jtrainer.make_optimizer(conf, lambda _: LR))
    jstate = jstate.replace(ema_params=jax.tree_util.tree_map(lambda a: a * 1.01,
                                                              jstate.params))
    key = jax.random.PRNGKey(80)
    jm = jeval(jstate, {n: jnp.asarray(v) for n, v in raw.items()}, key)
    state = port_state(trainer, variables, conf)
    with torch.no_grad():
        for n, v in state.ema_params.items():
            v.mul_(1.01)
    replay(trainer.model, [env["draw"](_step_key(key), env["shape"])])
    m = trainer._eval_step(state, {n: torch.from_numpy(v) for n, v in raw.items()},
                           torch.Generator())
    assert set(m) == set(jm)
    for n in jm:
        _metric_close(n, m[n], jm[n])

"""Parity of the PyTorch port's training pieces with credit_tpu: the losses,
the learning-rate schedules and `make_train_step` (AdamW, clipping, EMA, the
NaN guard, train-mode spectral norm, per-step backprop) on the tiny
CrossFormer.

The same numpy weights and batches go to both packages on the CPU, in f32.
The JAX model takes its XLA composition here; the port's kernels run their
plain PyTorch versions (kernel 2/4 forward and backward, kernel 1 and 5,
kernel 3 with the autograd backward), which tests/test_torch_port_grads.py
holds against the Pallas kernels.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import TINY_MODEL_CONF
from credit_tpu import losses as jlosses
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.trainers import scheduler as jsched
from credit_tpu.trainers.trainer import TrainState as JTrainState
from credit_tpu.trainers.trainer import make_optimizer as j_make_optimizer
from credit_tpu.trainers.trainer import make_train_step as j_make_train_step
from credit_torch import losses as tlosses
from credit_torch.convert_jax import from_jax_variables
from credit_torch.data.channels import ChannelSchema
from credit_torch.models import load_model
from credit_torch.trainers import scheduler as tsched
from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step
from tests.test_torch_port_model import DATA, _numpy_variables, _to_numpy
from torch_port_fixtures import jit_lowopt, two_torch_threads  # noqa: F401


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# --------------------------------------------------------------- losses
@pytest.mark.parametrize("name", ["mse", "mae", "msle", "huber", "logcosh", "xtanh",
                                  "xsigmoid"])
def test_weighted_loss_matches_reference(name):
    """Each elementwise loss under latitude and variable weights, f32
    (1e-6 relative: the mean of the same field in another order)."""
    rng = np.random.default_rng(0)
    shape = (2, 1, 6, 8, 5)
    target = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    pred = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    lat_w = rng.uniform(0.2, 1.5, 6).astype(np.float32)
    var_w = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    jl = jlosses.WeightedLoss(base=name, lat_weights=lat_w, var_weights=var_w)
    tl = tlosses.WeightedLoss(base=name, lat_weights=lat_w, var_weights=var_w)
    ref = float(jl(jnp.asarray(target), jnp.asarray(pred)))
    out = float(tl(torch.from_numpy(target), torch.from_numpy(pred)))
    assert abs(out - ref) <= 1e-6 * abs(ref)
    # unweighted field, elementwise
    np.testing.assert_allclose(_np(tlosses.load_loss(name)(torch.from_numpy(target),
                                                           torch.from_numpy(pred))),
                               _np(jlosses.load_loss(name)(jnp.asarray(target),
                                                           jnp.asarray(pred))),
                               rtol=1e-5, atol=1e-6)


def test_weighted_loss_from_config_and_unported_terms():
    conf = {"loss": {"training_loss": "mse", "use_latitude_weights": True,
                     "use_variable_weights": True,
                     "variable_weights": {"U": [1.0, 2.0], "SP": 0.5}}}

    class Grid:
        def coslat_weights(self):
            return np.array([0.5, 1.0, 1.5], np.float32)

    tl = tlosses.WeightedLoss.from_config(conf, Grid())
    jl = jlosses.WeightedLoss.from_config(conf, Grid())
    rng = np.random.default_rng(1)
    t, p = (rng.standard_normal((1, 1, 3, 4, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(tl(torch.from_numpy(t), torch.from_numpy(p))),
                               float(jl(jnp.asarray(t), jnp.asarray(p))), rtol=1e-6)
    # the spectral and power terms and the CRPS family are ported
    # (tests/test_torch_port_ensemble.py holds each against credit_tpu)
    conf["loss"].update(use_spectral_loss=True, spectral_lambda_reg=0.1, spectral_wavenum_init=1)
    tl = tlosses.WeightedLoss.from_config(conf, Grid())
    jl = jlosses.WeightedLoss.from_config(conf, Grid())
    assert tl.spectral_lambda == 0.1 and not tl.is_ensemble
    np.testing.assert_allclose(float(tl(torch.from_numpy(t), torch.from_numpy(p))),
                               float(jl(jnp.asarray(t), jnp.asarray(p))), rtol=1e-6)
    assert tlosses.WeightedLoss(base="KCRPS").is_ensemble
    # DownscalingLoss is ported (tests/test_torch_port_models.py holds it
    # against credit_tpu's), and so is the device-ring CRPS, dense outside
    # a process group (tests/test_torch_port_parallel.py)
    ds = tlosses.WeightedLoss.from_config({"data": {"datasets": {}}})
    assert isinstance(ds, tlosses.DownscalingLoss) and ds.base_name == "mse"
    assert tlosses.WeightedLoss(base="ring-crps").is_ensemble


# --------------------------------------------------------------- schedules
SCHEDULES = {
    "warmup_cosine": lambda m: m.warmup_cosine(1e-3, 5, 30, 1e-5),
    "cosine_warmup_restarts": lambda m: m.cosine_warmup_restarts(1e-3, 10, 1.5, 3, 0.5, 1e-5),
    "lambda_phased": lambda m: m.lambda_phased(1e-3, 4, 10, 0.5),
    "constant": lambda m: m.constant(3e-4),
    "load_scheduler": lambda m: m.load_scheduler({"trainer": {
        "learning_rate": 2e-4, "use_scheduler": True,
        "scheduler": {"scheduler_type": "cosine-annealing-restarts",
                      "first_cycle_steps": 8, "warmup_steps": 2}}}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    """Every ported schedule at optax counts 0..59 (f32 on the JAX side)."""
    js, ts = SCHEDULES[name](jsched), SCHEDULES[name](tsched)
    for count in range(60):
        np.testing.assert_allclose(ts(count), float(js(jnp.asarray(count))), rtol=1e-5,
                                   atol=1e-9, err_msg=f"count {count}")
    assert tsched.annealed_probability(30, 100) == jsched.annealed_probability(30, 100)


# --------------------------------------------------------------- train step
LR = 1e-3
CONF = {**copy.deepcopy(TINY_MODEL_CONF), "data": DATA,
        "trainer": {"learning_rate": LR, "weight_decay": 0.01, "grad_max_norm": 1.0}}
FORECAST = 2
STEPS = 3
EMA = 0.99


@pytest.fixture(scope="module")
def setup():
    """JAX model, converged numpy variables, schema, batches (3 steps)."""
    jmodel = jax_load_model(CONF)
    rng = np.random.default_rng(5)
    schema = ChannelSchema.from_config(CONF)
    b, h, w = 1, 32, 64
    x = rng.standard_normal((b, 1, h, w, schema.n_input)).astype(np.float32)
    variables = _to_numpy(_numpy_variables(jmodel, x, 2))
    batches = []
    for _ in range(STEPS):
        batches.append({
            "x": rng.standard_normal((b, 1, h, w, schema.n_input)).astype(np.float32) * 0.5,
            "y": rng.standard_normal((b, FORECAST, h, w, schema.n_target)).astype(np.float32)
            * 0.5,
            "forcing": rng.standard_normal(
                (b, FORECAST, h, w, len(schema.dynamic_forcing_indices()))).astype(np.float32)
            * 0.5})
    return jmodel, variables, schema, batches


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def _run_jax(jmodel, variables, schema, batches, bp):
    optimizer = j_make_optimizer(CONF, lambda _: LR)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        spectral=jax.tree_util.tree_map(jnp.asarray, variables["spectral"]),
                        opt_state=optimizer.init(params), ema_params=params)
    step = jit_lowopt(j_make_train_step(jmodel, jlosses.WeightedLoss(base="mse"), optimizer,
                                        JSchema.from_config(CONF), forecast_len=FORECAST,
                                        backprop_on_timestep=bp, ema_decay=EMA))
    losses, first_mu = [], None
    for i, bt in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in bt.items()},
                        jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
        if i == 0:
            first_mu = _flat(jax.device_get(state.opt_state[1][0].mu))
    return losses, first_mu, state


def _run_port(variables, schema, batches, bp):
    model = load_model(CONF, device="cpu", sn_state=True)
    model.load_state_dict(from_jax_variables(variables, CONF, device="cpu", fold=False))
    optimizer = make_optimizer(CONF, tsched.constant(LR))
    state = TrainState.create(model, optimizer, ema=True)
    step = make_train_step(model, tlosses.WeightedLoss(base="mse"), optimizer, schema,
                           forecast_len=FORECAST, backprop_on_timestep=bp, ema_decay=EMA,
                           device="cpu")
    losses, first_mu = [], None
    for i, bt in enumerate(batches):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in bt.items()})
        assert m["finite"] == 1.0
        losses.append(float(m["loss"]))
        if i == 0:
            first_mu = {k: v.clone().numpy() for k, v in state.opt_state["mu"].items()}
    return losses, first_mu, state


@pytest.mark.parametrize("bp", [[0, 1], [1]], ids=["backprop_all", "backprop_last"])
def test_train_step_matches_reference(setup, bp):
    """Three optimizer steps of a 2-step rollout with clipping, weight
    decay and EMA on, against credit_tpu's make_train_step from the same
    weights and batches (f32).

    - losses: 1e-5 relative (summation order through ~25 layers);
    - step-1 gradients, read from AdamW's first moment (mu = 0.1 clip(g) on
      both sides): 1e-4 of max |g| per parameter, where a parameter's max
      counts as at least 1e-2 of the largest gradient: the DPB output bias,
      which the softmax cannot see, has a true gradient of zero and only
      summation noise;
    - spectral u/v after 3 steps: 1e-5 plus what the two sides' kernel
      difference propagates to. Each forward's power iteration maps a
      kernel error dW to a u (or v) error of at most ||dW|| (1 + s2/s1) /
      s1 <= 2 ||dW||_F / sigma (s1 = sigma and s2 the two largest
      singular values; the earlier vectors' error contracts by s2/s1), so
      after STEPS forwards the bound adds 2 STEPS ||dW||_F / sigma of the
      final kernels, whose elements the parameter check below holds;
    - parameters and their EMA after 3 steps: within 0.05 lr. Adam divides
      each gradient by its own running RMS, so summation-order noise in
      gradients near zero becomes update noise of up to ~lr per step; the
      loose bound says the updates agree in sign and size, not to the bit.
      Where the true gradient is zero (below 1e-6 of the largest: the DPB
      output bias; a conv bias that a one-channel GroupNorm group removes;
      single kernel elements, e.g. one of cel0.conv0's at 5e-7 of its
      kernel's largest) the update is that noise alone, and both sides
      only stay within the Adam step bound, 2 lr per step. The rule is
      applied element by element.
    """
    jmodel, variables, schema, batches = setup
    jl, jmu, jstate = _run_jax(jmodel, variables, schema, batches, bp)
    tl, tmu, tstate = _run_port(variables, schema, batches, bp)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-5 * abs(b), (tl, jl)
    assert set(tmu) == set(jmu)
    gmax = max(np.abs(v).max() for v in jmu.values())
    for k, ref in jmu.items():
        scale = max(np.abs(ref).max(), 1e-2 * gmax)
        assert np.abs(tmu[k] - ref).max() <= 1e-4 * scale, k
    state = tstate.model.state_dict()
    spec = _flat(jax.device_get(jstate.spectral))
    assert spec and all(k in state for k in spec)
    jp, je = _flat(jax.device_get(jstate.params)), _flat(jax.device_get(jstate.ema_params))
    for k, ref in spec.items():
        kern = k.rpartition(".")[0] + ".kernel"
        w = jp[kern].reshape(-1, jp[kern].shape[-1]).T.astype(np.float64)
        sigma = spec[kern[:-6] + "u"] @ (w @ spec[kern[:-6] + "v"])
        dw = np.linalg.norm(state[kern].numpy().astype(np.float64) - jp[kern])
        np.testing.assert_allclose(state[k].numpy(), ref, rtol=0,
                                   atol=1e-5 + 2 * STEPS * dw / sigma, err_msg=k)
    assert set(jp) == set(tstate.ema_params)
    for k, ref in jp.items():
        tol = np.where(np.abs(jmu[k]) > 1e-6 * gmax, 0.05 * LR, 2 * STEPS * LR)
        for got, want in ((state[k].numpy(), ref), (tstate.ema_params[k].numpy(), je[k])):
            err = np.abs(got - want)
            assert (err <= tol).all(), (k, float((err / tol).max()))
    assert tstate.step == STEPS and tstate.opt_state["count"] == STEPS


def test_nan_guard_keeps_params_and_advances_moments(setup):
    """A non-finite loss: finite 0, zero gradients, the moments still
    advance (mu = b1 mu), the parameters and u/v... the parameters stay, as
    credit_tpu's jnp.where guard does."""
    _, variables, schema, batches = setup
    model = load_model(CONF, device="cpu", sn_state=True)
    model.load_state_dict(from_jax_variables(variables, CONF, device="cpu", fold=False))
    optimizer = make_optimizer(CONF, tsched.constant(LR))
    state = TrainState.create(model, optimizer, ema=True)
    step = make_train_step(model, tlosses.WeightedLoss(base="mse"), optimizer, schema,
                           forecast_len=1, ema_decay=EMA, device="cpu")
    good = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    state, m = step(state, good)
    assert m["finite"] == 1.0
    before = {k: v.clone() for k, v in model.named_parameters()}
    mu = {k: v.clone() for k, v in state.opt_state["mu"].items()}
    bad = dict(good, y=good["y"].clone())
    bad["y"][0, 0, 0, 0, 0] = float("nan")
    state, m = step(state, bad)
    assert m["finite"] == 0.0 and not np.isfinite(float(m["loss"]))
    assert float(m["grad_norm"]) == 0.0
    assert state.opt_state["count"] == 2
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k]), k
        torch.testing.assert_close(state.opt_state["mu"][k], 0.9 * mu[k], rtol=1e-6, atol=0)


def test_train_step_refuses_unported_options(setup):
    """The normalizer, stateless postblocks, metrics and the final state
    (tests/test_torch_port_fit.py), ensembles and sn_external
    (tests/test_torch_port_ensemble.py), preblocks
    (tests/test_torch_port_preblock.py) and stateful and trainable
    postblocks (tests/test_torch_port_skebs.py) are ported; a trainable
    postblock with a state that lacks its net is refused."""
    _, _, schema, _ = setup
    model = load_model(CONF, device="cpu")
    opt = make_optimizer(CONF, tsched.constant(LR))
    loss = tlosses.WeightedLoss()

    class Trainable:
        is_stateful = is_trainable = True

    step = make_train_step(model, loss, opt, schema, device="cpu", postblocks=[Trainable()])
    state = TrainState.create(model, opt)
    with pytest.raises(ValueError, match="nets"):
        step(state, {})
    assert make_train_step(model, loss, opt, schema, device="cpu", preblocks=[lambda x: x],
                           preblocks_ic=[lambda x: x]) is not None
    assert make_train_step(model, loss, opt, schema, device="cpu", normalizer=object(),
                           postblocks=[lambda y, x: y], return_final_state=True) is not None
    assert make_train_step(model, loss, opt, schema, device="cpu", ensemble_size=2,
                           sn_external=True) is not None
    # the TPU levers are accepted and ignored
    conf = copy.deepcopy(CONF)
    conf["trainer"]["flatten_optimizer"] = True
    conf["model"].update(scan_blocks=True, remat=True)
    assert make_optimizer(conf, tsched.constant(LR)).clip == 1.0
    assert load_model(conf, device="cpu", sn_state=True) is not None

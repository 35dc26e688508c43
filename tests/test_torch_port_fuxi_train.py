"""Parity of the PyTorch port's FuXi training step with credit_tpu:
`make_train_step` with two input frames (history_len=2) on a tiny FuXi,
three optimizer steps from the same numpy weights and batches, f32. The JAX
model takes its XLA composition on the CPU; the port's kernels run their
plain versions (the post-norm FF forward and backward, the VALID conv and
its weight gradient), which tests/test_torch_port_fuxi.py holds against the
Pallas kernels.

The parity config's SwinV2 stage needs no zero pad: where it pads,
credit_tpu's gradient of block 0's qkv kernel is NaN (its cosine attention
divides k by jnp.linalg.norm(k), whose gradient at the padded tokens' k = 0
is NaN), while the port's torch.linalg.vector_norm has a zero subgradient
there.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu import losses as jlosses
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.trainers.trainer import TrainState as JTrainState
from credit_tpu.trainers.trainer import make_optimizer as j_make_optimizer
from credit_tpu.trainers.trainer import make_train_step as j_make_train_step
from credit_torch import losses as tlosses
from credit_torch.convert_jax import from_jax_variables, init_train
from credit_torch.data.channels import ChannelSchema
from credit_torch.models import load_model
from credit_torch.trainers import scheduler as tsched
from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step
from tests.test_fuxi_swin import FUXI_CONF
from tests.test_torch_port_model import DATA, _numpy_variables, _to_numpy
from tests.test_torch_port_train import _flat

LR = 1e-3
CONF = {**copy.deepcopy(FUXI_CONF), "data": DATA,
        "trainer": {"learning_rate": LR, "weight_decay": 0.01, "grad_max_norm": 1.0}}
# 48x64, earth-padded to 64x64: the stage runs at 8x8, two windows of 4 a
# side, shifted by 2 in odd blocks, with no zero pad
CONF["model"].update(image_height=48, padding_conf={"activate": True, "mode": "earth",
                                                    "pad_lat": [8, 8], "pad_lon": [0, 0]})
HISTORY = 2
FORECAST = 2
STEPS = 3
EMA = 0.99


@pytest.fixture(scope="module")
def setup():
    """JAX model, converged numpy variables, schema and 3 batches of two
    input frames."""
    jmodel = jax_load_model(CONF)
    rng = np.random.default_rng(7)
    schema = ChannelSchema.from_config(CONF)
    b, h, w = 1, 48, 64
    x = rng.standard_normal((b, HISTORY, h, w, schema.n_input)).astype(np.float32)
    variables = _to_numpy(_numpy_variables(jmodel, x, 3))
    batches = [{
        "x": rng.standard_normal((b, HISTORY, h, w, schema.n_input)).astype(np.float32) * 0.5,
        "y": rng.standard_normal((b, FORECAST, h, w, schema.n_target)).astype(np.float32) * 0.5,
        "forcing": rng.standard_normal(
            (b, FORECAST, h, w, len(schema.dynamic_forcing_indices()))).astype(np.float32) * 0.5,
    } for _ in range(STEPS)]
    return jmodel, variables, schema, batches


def _run_jax(jmodel, variables, batches):
    optimizer = j_make_optimizer(CONF, lambda _: LR)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        spectral=jax.tree_util.tree_map(jnp.asarray, variables["spectral"]),
                        opt_state=optimizer.init(params), ema_params=params)
    step = jax.jit(j_make_train_step(jmodel, jlosses.WeightedLoss(base="mse"), optimizer,
                                     JSchema.from_config(CONF), forecast_len=FORECAST,
                                     history_len=HISTORY, ema_decay=EMA))
    losses, first_mu = [], None
    for i, bt in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in bt.items()}, jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
        if i == 0:
            first_mu = _flat(jax.device_get(state.opt_state[1][0].mu))
    return losses, first_mu, state


def _run_port(variables, schema, batches):
    model = load_model(CONF, device="cpu", sn_state=True)
    model.load_state_dict(from_jax_variables(variables, CONF, device="cpu", fold=False))
    optimizer = make_optimizer(CONF, tsched.constant(LR))
    state = TrainState.create(model, optimizer, ema=True)
    step = make_train_step(model, tlosses.WeightedLoss(base="mse"), optimizer, schema,
                           forecast_len=FORECAST, history_len=HISTORY, ema_decay=EMA,
                           device="cpu")
    losses, first_mu = [], None
    for i, bt in enumerate(batches):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in bt.items()})
        assert m["finite"] == 1.0
        losses.append(float(m["loss"]))
        if i == 0:
            first_mu = {k: v.clone().numpy() for k, v in state.opt_state["mu"].items()}
    return losses, first_mu, state


def test_fuxi_train_step_matches_reference(setup):
    """Three optimizer steps of a 2-step rollout from two input frames, with
    clipping, weight decay and EMA on, against credit_tpu's make_train_step:
    losses within 1e-5 relative; step-1 gradients (AdamW's first moment)
    within 1e-4 of each parameter's max |g|, counted as at least 1e-2 of the
    largest gradient; the SN convs' u/v within 1e-5; parameters and their
    EMA within 0.05 lr (2 lr per step where the true gradient is zero), as
    tests/test_torch_port_train.py sets out."""
    jmodel, variables, schema, batches = setup
    jl, jmu, jstate = _run_jax(jmodel, variables, batches)
    tl, tmu, tstate = _run_port(variables, schema, batches)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-5 * abs(b), (tl, jl)
    assert set(tmu) == set(jmu)
    gmax = max(np.abs(v).max() for v in jmu.values())
    for k, ref in jmu.items():
        scale = max(np.abs(ref).max(), 1e-2 * gmax)
        assert np.abs(tmu[k] - ref).max() <= 1e-4 * scale, k
    state = tstate.model.state_dict()
    spec = _flat(jax.device_get(jstate.spectral))
    assert len(spec) == 12 and all(k in state for k in spec)
    for k, ref in spec.items():
        np.testing.assert_allclose(state[k].numpy(), ref, atol=1e-5, err_msg=k)
    jp, je = _flat(jax.device_get(jstate.params)), _flat(jax.device_get(jstate.ema_params))
    assert set(jp) == set(tstate.ema_params)
    for k, ref in jp.items():
        tol = 0.05 * LR if np.abs(jmu[k]).max() > 1e-6 * gmax else 2 * STEPS * LR
        np.testing.assert_allclose(state[k].numpy(), ref, rtol=0, atol=tol, err_msg=k)
        np.testing.assert_allclose(tstate.ema_params[k].numpy(), je[k], rtol=0, atol=tol,
                                   err_msg=k)
    assert tstate.step == STEPS and tstate.opt_state["count"] == STEPS


def test_fuxi_training_on_a_padded_stage_stays_finite():
    """credit_tpu's own tiny FuXi, whose stage pads 5x9 to 8x12: one
    train-mode forward and backward of the port with SN state gives a finite
    loss and finite gradients everywhere (credit_tpu's are NaN in block 0's
    qkv kernel, see the module docstring)."""
    conf = {**copy.deepcopy(FUXI_CONF), "data": DATA}
    model = init_train(conf, torch.Generator().manual_seed(0), device="cpu").train()
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 2, 32, 64, model.base_input_channels), generator=g)
    loss = (model(x) ** 2).mean()
    loss.backward()
    assert torch.isfinite(loss)
    for k, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k
    assert model.u_transformer.swin.block0.attn.qkv.kernel.grad.abs().max() > 0

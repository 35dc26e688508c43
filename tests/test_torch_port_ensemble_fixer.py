"""Parity of the port's ensemble step behind the tracer fixer with
credit_tpu's, as the ensemble configs run it: one micro-step of the tiny
`crossformer-ensemble` (E = 3 members of 2 samples, the almost-fair CRPS
with its spectral terms, the Normalizer, Denorm -> TracerFixer -> Renorm
on every member before the loss, grad_accum_every 2, sn_external).

credit_tpu's jitted step takes a wrong gradient through the fixer on
XLA:CPU (tests/test_torch_port_ensemble.py: test_crps_gradient_through_
the_tracer_fixer), and its whole step under `jax.disable_jit()` takes
~220 s here (~3,000 one-op XLA compiles of ~47 ms each, the tiny config
being at depth 1 in every stage already). So credit_tpu's step gradient
is taken by the chain rule the step's value_and_grad applies: the
cotangent of the step's loss behind its postblocks at credit_tpu's own
prediction, under `jax.disable_jit()` (op by op, as the loss-level test
holds it to the exact gradient), pulled back through jax.vjp of
credit_tpu's forward (jitted: tests/test_torch_port_ensemble_fit.py holds
the port's backward to it within 1.3e-6). The port runs its whole step,
replaying credit_tpu's noise, f32 on the CPU, with the tolerances of
tests/test_torch_port_ensemble_fit.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu.models.layers import freeze_sn_updates
from credit_torch.models.spectral_utils import power_iter_model_
# env and the autouse python_reference_reader are fixtures: imported, they
# apply here too
from tests.test_torch_port_ensemble import (E, LR, _jstate, _port_tree, _step_key,  # noqa: F401
                                            ens_conf, env, port_state, port_trainer,
                                            python_reference_reader, replay)
from tests.test_torch_port_ensemble_fit import (LEAF_TOL, NORM_TOL, ULP2, _jax_trainer,
                                                _jax_tree, _leaf_errors, _norm)
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def fixer_step(env):
    """One micro-step from the same state on both sides, after one
    sn_external power iteration. credit_tpu's gradient: jax.vjp of its
    forward (spectral norm frozen, the step's noise key) at the cotangent,
    taken under jax.disable_jit(), of its loss behind Denorm, TracerFixer
    and Renorm, as its train step composes them (loss_of). The port's:
    what its step hands its optimizer. The port's step starts at mini-step
    1, so that it takes the update, which is then held against credit_tpu's
    optimizer on the port's gradient from the same state."""
    conf = ens_conf(env, env["root"] / "fixer")
    jt, trainer = _jax_trainer(env, conf), port_trainer(conf)
    raw = trainer.dataset.batch([0, 1], 1)
    key = jax.random.PRNGKey(70)
    noise = env["draw"](_step_key(key), env["shape"])

    jstate = _jstate(env["variables"], jt.optimizer)
    before = jstate.replace(spectral=jt._sn_update(jstate.params, jstate.spectral, n_iter=1))
    jnorm, jmodel = jt.normalizer, env["jmodel"]
    x_in = jnorm.normalize_input(jnp.repeat(jnp.asarray(raw["x"]), E, axis=0))
    target = jnorm.normalize_target(jnp.asarray(raw["y"]))[:, :1]

    def forward(params):
        with freeze_sn_updates():
            return jmodel.apply({"params": params, "spectral": before.spectral}, x_in,
                                train=True, rngs={"noise": _step_key(key)})

    def loss_of_prediction(y):
        for b in jt.train_postblocks:
            y = b(y, x_in)
        return jt.loss_fn(target, y.reshape(target.shape[0], E, *y.shape[1:]))

    y_ref, pullback = jax.vjp(jax.jit(forward), before.params)
    with jax.disable_jit():
        loss_ref, cot = jax.value_and_grad(loss_of_prediction)(y_ref)
    grad_ref = _port_tree(before.replace(params=pullback(cot)[0]), conf)

    state = port_state(trainer, env["variables"], conf)
    state.opt_state["mini_step"] = 1
    model = trainer.model
    power_iter_model_(model, 1)
    names, seen = list(state.opt_state["mu"]), {}
    update = trainer.optimizer.update

    def recording(grads, st, params):
        seen["grads"] = {n: g.clone() for n, g in zip(names, grads)}
        return update(grads, st, params)

    trainer.optimizer.update = recording
    params_before = {n: p.detach().clone() for n, p in model.named_parameters()}
    try:
        replay(model, [noise])
        state, m = trainer._train_step_for(1)(state, {n: torch.from_numpy(v)
                                                      for n, v in raw.items()})
    finally:
        trainer.optimizer.update = update
        del model.forward
    return {"conf": conf, "jt": jt, "trainer": trainer, "before": before, "m": m,
            "loss_ref": float(loss_ref), "grad_ref": {n: grad_ref[n] for n in names},
            "grad": seen["grads"], "state": state, "params_before": params_before}


def test_fixer_step_runs_the_configured_pipeline(fixer_step):
    trainer = fixer_step["trainer"]
    assert [type(b).__name__ for b in trainer.train_postblocks] == [
        "Denorm", "TracerFixer", "Renorm"]
    assert [type(b).__name__ for b in fixer_step["jt"].train_postblocks] == [
        "Denorm", "TracerFixer", "Renorm"]
    assert trainer.ensemble_size == E and trainer.sn_external


def test_fixer_step_gradient_matches_reference(fixer_step):
    """The gradient the port's step hands its optimizer equals credit_tpu's
    step gradient within LEAF_TOL a leaf and NORM_TOL of the norm; the loss
    within 1e-5; the reported gradient norm within |d g| of credit_tpu's."""
    ref, got = fixer_step["grad_ref"], fixer_step["grad"]
    worst = max(_leaf_errors(got, ref).items(), key=lambda kv: kv[1])
    assert worst[1] <= LEAF_TOL, worst
    diff, norm = _norm({n: got[n] - g for n, g in ref.items()}), _norm(ref)
    assert diff <= NORM_TOL * norm, diff / norm
    m = fixer_step["m"]
    np.testing.assert_allclose(float(m["loss"]), fixer_step["loss_ref"], rtol=1e-5)
    assert abs(float(m["grad_norm"]) - norm) <= diff + 1e-6 * norm


def test_fixer_step_update_matches_reference(fixer_step):
    """The port's parameters and EMA after the update are what credit_tpu's
    optimizer and EMA make of the port's gradient from the same state,
    within 1e-5 lr of every element plus f32 rounding; most parameters
    moved. At its second mini-step from a zero running mean, optax.
    MultiSteps hands its inner chain (the clip and AdamW) the mean g / 2,
    exact in f32; the inner chain runs on that here."""
    before, conf, state = fixer_step["before"], fixer_step["conf"], fixer_step["state"]
    mean = jax.tree_util.tree_map(lambda g: g / 2, _jax_tree(fixer_step["grad"], before.params))
    upd, _ = jax.jit(fixer_step["jt"].optimizer.inner_opt.update)(
        mean, before.opt_state.inner_opt_state, before.params)
    # optax.apply_updates and the step's EMA, in f32 on the host
    new = jax.tree_util.tree_map(lambda p, u: np.asarray(p) + np.asarray(u), before.params, upd)
    d = np.float32(min(conf["trainer"]["ema_decay"], 1.0 / 10.0))
    ema = jax.tree_util.tree_map(lambda e, p: np.asarray(e) * d + p * (np.float32(1) - d),
                                 before.ema_params, new)
    want, want_ema = (_port_tree(before.replace(params=t), conf) for t in (new, ema))
    assert state.opt_state["count"] == 1 and state.opt_state["mini_step"] == 0
    moved = total = 0
    for n, p in state.model.named_parameters():
        for got, ref in ((p.detach(), want[n]), (state.ema_params[n], want_ema[n])):
            err = (got - ref).abs()
            assert (err <= 1e-5 * LR + ULP2 * ref.abs()).all(), (n, (err / LR).max().item())
        moved += int(((p.detach() - fixer_step["params_before"][n]).abs() > 0.5 * LR).sum())
        total += p.numel()
    assert moved > 0.5 * total, moved / total

"""Parity of the port's ensemble (CRPS) fit with credit_tpu's: a 2-epoch
`Trainer.fit` of `crossformer-ensemble` on the zarr store (E = 3 members
of 2 samples, the almost-fair CRPS with its spectral terms,
`grad_accum_every` 2, `sn_external`), four micro-steps of the step
credit_tpu's Trainer compiled (two optimizer updates), the external
spectral norm and the port's resume.

The steps leave out the tracer fixer: credit_tpu's jitted step takes a
wrong CRPS gradient through it on XLA:CPU
(tests/test_torch_port_ensemble.py: test_crps_gradient_through_the_tracer_fixer).
The port replays credit_tpu's noise (tests/test_torch_port_ensemble.py:
_noise_drawer, replay), f32 on the CPU, at a learning rate (1e-3) at
which an update shows in the loss.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from credit_tpu import losses as jlosses
from credit_tpu.data import local as jlocal
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.data.normalize import Normalizer as JNormalizer
from credit_tpu.grid import Grid as JGrid
from credit_tpu.models.layers import freeze_sn_updates
from credit_tpu.trainers import trainer as jtrainer
from credit_torch.applications import run_training
from credit_torch.models.layers import freeze_sn_updates as port_freeze_sn_updates
from credit_torch.models.spectral_utils import power_iter_model_
from credit_torch.trainers.trainer import Trainer
# env and the autouse python_reference_reader are fixtures: imported, they
# apply here too
from tests.test_torch_port_ensemble import (E, H, LR, W, _close, _jstate, _metric_close,  # noqa: F401
                                            _port_tree, _read_log, _step_key, ens_conf, env,
                                            port_state, port_trainer, python_reference_reader,
                                            replay)
from torch_port_fixtures import jit_lowopt, two_torch_threads  # noqa: F401

# The gradients of the two steps part by f32 rounding, amplified where the
# loss is ill-conditioned (test_micro_step_gradients_match_reference). A
# leaf is held within LEAF_TOL of its largest element plus LEAF_FLOOR of
# the largest of all (leaves whose gradient cancels to ~1e-7 of it, the
# dynamic position bias's output bias and the last UpBlock's conv biases,
# are rounding alone); the whole within NORM_TOL of its norm, or 4 times
# credit_tpu's step's own distance from jax.vjp of its forward where that
# is larger.
LEAF_TOL, LEAF_FLOOR, NORM_TOL = 1e-2, 1e-4, 2e-4
# f32 rounding of a parameter, as a fraction of its size
ULP2 = 2.0 ** -22


def fit_conf(env, save_loc, **trainer):
    """ens_conf (tests/test_torch_port_ensemble.py) without the tracer
    fixer."""
    conf = ens_conf(env, save_loc, **trainer)
    conf["model"].pop("post_conf")
    return conf


def _jax_trainer(env, conf):
    jschema, jgrid = JSchema.from_config(conf), JGrid.regular(H, W)
    jnorm = JNormalizer.from_netcdf(jschema, *env["stats"])
    return jtrainer.Trainer(conf, env["jmodel"], jlosses.WeightedLoss.from_config(conf, jgrid),
                            jlosses.WeightedLoss.from_config(conf, jgrid, validation=True),
                            jschema, jlocal.load_dataset(conf, jschema, jgrid),
                            jlocal.load_dataset(conf, jschema, jgrid, "valid"),
                            save_loc=conf["save_loc"], normalizer=jnorm)


@pytest.fixture(scope="module")
def fits(env):
    """credit_tpu's and the port's 2-epoch ensemble fits from the same
    weights, one micro-step an epoch (the update falls in epoch 1), the
    port replaying credit_tpu's noise: its fit draws the key of each train
    batch from PRNGKey(seed) and of each validation batch from
    fold_in(PRNGKey(seed + 0x5EED), epoch)."""
    root, variables = env["root"], env["variables"]
    conf = fit_conf(env, root / "jax", batches_per_epoch=1, save_best_weights=False)
    jt = _jax_trainer(env, conf)
    jt.fit(_jstate(variables, jt.optimizer), seed=0)
    tconf = fit_conf(env, root / "port", batches_per_epoch=1)
    trainer = port_trainer(tconf)
    rng, draws = jax.random.PRNGKey(0), []
    for epoch in range(2):
        rng, sub = jax.random.split(rng)
        draws.append(env["draw"](_step_key(sub), env["shape"]))
        erng = jax.random.fold_in(jax.random.PRNGKey(0x5EED), epoch)
        _, ek = jax.random.split(erng)
        draws.append(env["draw"](_step_key(ek), env["shape"]))
    left = replay(trainer.model, draws)
    state = trainer.fit(port_state(trainer, variables, tconf), seed=0)
    assert left == []
    del trainer.model.forward
    return {"jax": _read_log(conf["save_loc"]), "port": _read_log(tconf["save_loc"]),
            "jt": jt, "trainer": trainer, "state": state, "conf": tconf,
            "update": jax.jit(jt.optimizer.update)}


def test_fit_log_matches_reference(fits):
    """Two epochs of credit_tpu's Trainer.fit and the port's, one
    micro-step each, the optimizer update in the second (the validation
    loss falls by more than 1e-3): the same columns, every cell but
    `seconds` and the gradient norm within 1e-5 (_metric_close); the
    gradient norm within NORM_TOL, the bound test_micro_step_gradients_
    match_reference holds the gradients to (|d |g|| <= |d g|)."""
    jlog, tlog = fits["jax"], fits["port"]
    assert tlog[0] == jlog[0] and len(tlog) == len(jlog) == 3
    header = tlog[0]
    assert sum(h.startswith("valid_") for h in header) == 1 + 4 * 8
    for trow, jrow in zip(tlog[1:], jlog[1:]):
        for name, a, b in zip(header, trow, jrow):
            if name != "seconds":
                _metric_close(name, a, b, NORM_TOL if "grad_norm" in name else 1e-5)
    valid = header.index("valid_loss")
    assert float(jlog[1][valid]) - float(jlog[2][valid]) > 1e-3
    state = fits["state"]
    assert state.step == 2 and state.opt_state["count"] == 1 and state.opt_state["mini_step"] == 0


def _jax_tree(named, like):
    """Port tensors by name as a JAX tree shaped as `like`: the inverse of
    from_jax_variables' flattening (names joined by '.', fold=False)."""
    tree = {}
    for name, v in named.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(v.numpy())
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(like)
    return tree


def _load_reference_state(state, jstate, conf):
    """Make the port's TrainState credit_tpu's: parameters and u/v, EMA,
    AdamW's moments and count, MultiSteps' running mean and mini-step, the
    step."""
    state.model.load_state_dict(_port_tree(jstate, conf))
    ms = jstate.opt_state
    adam = ms.inner_opt_state[1][0]
    trees = {"ema": _port_tree(jstate, conf, "ema_params")}
    for key, tree in [("mu", adam.mu), ("nu", adam.nu), ("acc", ms.acc_grads)]:
        trees[key] = _port_tree(jstate.replace(params=tree), conf)
    with torch.no_grad():
        for n in state.ema_params:
            state.ema_params[n].copy_(trees["ema"][n])
            for key in ("mu", "nu", "acc"):
                state.opt_state[key][n].copy_(trees[key][n])
    state.opt_state["count"] = int(adam.count)
    state.opt_state["mini_step"] = int(ms.mini_step)
    state.step = int(jstate.step)


@pytest.fixture(scope="module")
def micro_steps(env, fits):
    """Four micro-steps of the fit's step (E = 3 members of 2 samples, the
    almost-fair CRPS with its spectral terms, the Normalizer,
    grad_accum_every 2, sn_external with one power iteration first; the
    updates on the second and fourth) on credit_tpu's compiled step and the
    port's, each from credit_tpu's state before it, so that what one
    micro-step shows does not carry into the next. credit_tpu's gradient
    is its step's running mean from a zeroed one (a second call); the
    port's is what its step hands the optimizer. Beside the steps, each
    model's backward alone: the port's autograd and jax.vjp of credit_tpu's
    forward, both at credit_tpu's cotangent of the loss at its own
    prediction. Returns one record a micro-step."""
    jt, trainer, conf = fits["jt"], fits["trainer"], fits["conf"]
    jmodel, jnorm, model = env["jmodel"], jt.normalizer, fits["trainer"].model
    raws = [trainer.dataset.batch(t, 1) for t in ([0, 1], [2, 3])]
    jstate = _jstate(env["variables"], jt.optimizer)
    state = port_state(trainer, env["variables"], conf)
    step = trainer._train_step_for(1)
    names = list(state.opt_state["mu"])
    keys = [jax.random.PRNGKey(60 + i) for i in range(4)]
    noise = [env["draw"](_step_key(k), env["shape"]) for k in keys]
    copied = lambda s: jax.tree_util.tree_map(jnp.copy, s)  # noqa: E731: the step donates its state

    def jforward(params, spectral, x, key):
        with freeze_sn_updates():
            return jmodel.apply({"params": params, "spectral": spectral}, x, train=True,
                                rngs={"noise": key})

    @jit_lowopt
    def jbackward(params, spectral, x, key, target):
        y, vjp = jax.vjp(lambda p: jforward(p, spectral, x, key), params)
        cot = jax.grad(lambda y: jt.loss_fn(target, y.reshape(target.shape[0], E,
                                                               *y.shape[1:])))(y)
        return y, cot, vjp(cot)[0]

    seen = {}
    update = trainer.optimizer.update

    def recording(grads, st, params):
        seen["grads"] = {n: g.clone() for n, g in zip(names, grads)}
        return update(grads, st, params)

    trainer.optimizer.update = recording
    records = []
    try:
        for i, k in enumerate(keys):
            raw = raws[i % 2]
            jbatch = {n: jnp.asarray(v) for n, v in raw.items()}
            pre = copied(jstate)
            _load_reference_state(state, jstate, conf)
            jstate = jstate.replace(spectral=jt._sn_update(jstate.params, jstate.spectral,
                                                           n_iter=1))
            before = copied(jstate)
            x_in = jnorm.normalize_input(jnp.repeat(jbatch["x"], E, axis=0))
            target = jnorm.normalize_target(jbatch["y"])[:, :1]
            y_ref, cot, vjp_ref = jbackward(before.params, before.spectral, x_in, _step_key(k),
                                            target)
            probe = copied(before)
            ms = probe.opt_state
            probe = probe.replace(opt_state=ms._replace(
                mini_step=jnp.zeros_like(ms.mini_step),
                acc_grads=jax.tree_util.tree_map(jnp.zeros_like, ms.acc_grads)))
            acc = jt._train_step(probe, jbatch, k)[0].opt_state.acc_grads
            grad_ref = _port_tree(before.replace(params=acc), conf)
            vjp_ref = _port_tree(before.replace(params=vjp_ref), conf)
            jstate, jm = jt._train_step(jstate, jbatch, k)

            power_iter_model_(model, 1)
            uv = {n: b.clone() for n, b in model.named_buffers()}
            model.train()
            with port_freeze_sn_updates(True):
                y = type(model).forward(model, torch.from_numpy(np.array(x_in)), noise=noise[i])
            y.backward(torch.from_numpy(np.array(cot)))
            vjp = {n: p.grad.clone() for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            params_before = {n: p.detach().clone() for n, p in model.named_parameters()}
            ema_before = {n: v.clone() for n, v in state.ema_params.items()}
            replay(model, [noise[i]])
            state, m = step(state, {n: torch.from_numpy(v) for n, v in raw.items()})
            del model.forward
            records.append({
                "pre": pre, "before": before, "after": copied(jstate), "jm": jm, "m": m,
                "grad_ref": {n: grad_ref[n] for n in names}, "grad": seen.pop("grads"),
                "vjp_ref": {n: vjp_ref[n] for n in names}, "vjp": vjp,
                "y": y.detach(), "y_ref": np.asarray(y_ref), "uv": uv,
                "params_before": params_before, "ema_before": ema_before,
                "params": {n: p.detach().clone() for n, p in model.named_parameters()},
                "buffers": {n: b.clone() for n, b in model.named_buffers()},
                "ema": {n: v.clone() for n, v in state.ema_params.items()},
                "acc": {n: v.clone() for n, v in state.opt_state["acc"].items()},
                "step": state.step, "count": state.opt_state["count"],
                "mini_step": state.opt_state["mini_step"]})
    finally:
        trainer.optimizer.update = update
        if "forward" in vars(model):
            del model.forward
    return records


def _update_sensitive(mean, mean_ref):
    """Elements of the first update that the two sides' mean gradients
    decide differently: AdamW's first step from zero moments, g / (|g| +
    eps) (no clip below a norm of 1), moved by more than a quarter of 1e-5
    between credit_tpu's mean gradient and the port's (the rest of the
    1e-5 for the rounding of the moments)."""
    out = {}
    for n, ref in mean_ref.items():
        mine, ref = mean[n].double(), ref.double()
        out[n] = (mine / (mine.abs() + 1e-8) - ref / (ref.abs() + 1e-8)).abs() > 2.5e-6
    return out


def _check_update(rec, fits):
    """The port's parameters and EMA after an update equal what credit_tpu's
    optimizer (optax.MultiSteps over the clip and AdamW) and EMA make of the
    port's own gradient from the same state, within 1e-5 lr of every
    element plus f32 rounding."""
    before, conf = rec["before"], fits["conf"]
    upd, _ = fits["update"](_jax_tree(rec["grad"], before.params), before.opt_state,
                            before.params)
    new = optax.apply_updates(before.params, upd)
    d = min(conf["trainer"]["ema_decay"], (1.0 + int(before.step)) / (10.0 + int(before.step)))
    ema = jax.tree_util.tree_map(lambda e, p: e * d + p * (1.0 - d), before.ema_params, new)
    want, want_ema = (_port_tree(before.replace(params=t), conf) for t in (new, ema))
    for n in rec["params"]:
        for got, ref in ((rec["params"][n], want[n]), (rec["ema"][n], want_ema[n])):
            err = (got - ref).abs()
            assert (err <= 1e-5 * LR + ULP2 * ref.abs()).all(), (n, (err / LR).max().item())


def _norm(tree):
    return torch.sqrt(sum((g.double() ** 2).sum() for g in tree.values())).item()


def _leaf_errors(got, want):
    """Each leaf's largest error over its largest element plus LEAF_FLOOR
    of the largest of all."""
    gmax = max(g.abs().max().item() for g in want.values())
    return {n: (got[n] - g).abs().max().item() / (g.abs().max().item() + LEAF_FLOOR * gmax)
            for n, g in want.items()}


def test_micro_step_gradients_match_reference(micro_steps):
    """At each of the four micro-steps, from credit_tpu's state:
    - the predictions agree within 1e-5, and the port's backward through
      the model at credit_tpu's cotangent of the loss equals jax.vjp of
      credit_tpu's forward at it within 1e-5 of the norm (read: 7e-7 to
      1.3e-6) and LEAF_TOL a leaf;
    - the gradient the port's step hands its optimizer equals credit_tpu's
      step's within LEAF_TOL a leaf and NORM_TOL, or 4 times credit_tpu's
      own distance from its forward's VJP, of the norm (read on two
      PyTorch threads: 8.8e-5, 4.7e-5, 2.0e-5, 2.1e-4 against 2.6e-5,
      5.2e-5, 2.6e-5, 4.3e-4 of credit_tpu's), and the gradient norm it
      reports is within |d g| of credit_tpu's.
    At micro-step 3 the power loss's cotangent sits on one latitude row of
    T2M, where the member mean's power nearly vanishes at one wavenumber
    (log(psd + 1e-8)); the row carries 0.9 of the gradient's norm and turns
    the rounding of the prediction into 2e-4 of it on the port's side (1e-3
    on eight threads) and 4e-4 between credit_tpu's step and its own
    forward's VJP."""
    self_diff = []
    for i, rec in enumerate(micro_steps):
        _close(rec["y"].numpy(), rec["y_ref"], 1e-5, (i, "prediction"))
        vjp, vjp_ref = rec["vjp"], rec["vjp_ref"]
        assert _norm({n: vjp[n] - g for n, g in vjp_ref.items()}) <= 1e-5 * _norm(vjp_ref), i
        worst = max(_leaf_errors(vjp, vjp_ref).items(), key=lambda kv: kv[1])
        assert worst[1] <= LEAF_TOL, (i, "vjp", worst)
        ref, got = rec["grad_ref"], rec["grad"]
        worst = max(_leaf_errors(got, ref).items(), key=lambda kv: kv[1])
        assert worst[1] <= LEAF_TOL, (i, worst)
        diff, norm = _norm({n: got[n] - g for n, g in ref.items()}), _norm(ref)
        self_diff.append(_norm({n: vjp_ref[n] - g for n, g in ref.items()}) / norm)
        assert diff <= max(NORM_TOL, 4 * self_diff[-1]) * norm, (i, diff / norm, self_diff)
        gap = abs(float(rec["m"]["grad_norm"]) - float(rec["jm"]["grad_norm"]))
        assert gap <= diff + 1e-6 * norm, (i, gap, diff)
    assert self_diff[3] > 1e-4, self_diff


def test_ensemble_train_steps_match_reference(env, fits, micro_steps):
    """The first two micro-steps, the second taking the first update: the
    loss, every metric (on the member mean) and the final state within
    1e-5 (_metric_close; the gradient norm: test_micro_step_gradients_match_
    reference); the update and EMA exactly what credit_tpu's optimizer
    makes of the port's gradient (_check_update); and the parameters and
    EMA against credit_tpu's own within 1e-5 lr plus rounding, save the
    elements whose first step the two sides' mean gradients decide
    differently (_update_sensitive: 67638 of 829685, 8.2%, those with a
    mean gradient within ~40 eps of 0, where g / (|g| + eps) turns a
    1e-4 difference of g into more than 2.5e-6 of the step). 98.9% of the
    parameters moved by more than lr / 2."""
    conf = fits["conf"]
    for i, rec in enumerate(micro_steps[:2]):
        m, jm = dict(rec["m"]), rec["jm"]
        assert set(m) == set(jm)
        _close(m.pop("_final_x").numpy(), jm["_final_x"], 1e-5, (i, "_final_x"))
        for name, v in m.items():
            if name != "grad_norm":
                _metric_close(name, v, jm[name])
    rec = micro_steps[1]
    _check_update(rec, fits)
    # the port's running mean started from credit_tpu's first micro-gradient
    first = micro_steps[0]["grad_ref"]
    sensitive = _update_sensitive({n: (first[n] + g) / 2 for n, g in rec["grad"].items()},
                                  {n: (first[n] + g) / 2 for n, g in rec["grad_ref"].items()})
    want = _port_tree(rec["after"], conf)
    want_ema = _port_tree(rec["after"], conf, "ema_params")
    n_sensitive = n_total = moved = 0
    for n, p in rec["params"].items():
        keep = ~sensitive[n]
        for got, ref in ((p, want[n]), (rec["ema"][n], want_ema[n])):
            err = (got - ref).abs()[keep]
            assert (err <= 1e-5 * LR + ULP2 * ref.abs()[keep]).all(), (n, (err / LR).max().item())
        n_sensitive += int(sensitive[n].sum())
        n_total += p.numel()
        moved += int(((p - rec["params_before"][n]).abs() > 0.5 * LR).sum())
    assert n_sensitive <= 0.12 * n_total, n_sensitive / n_total
    assert moved > 0.5 * n_total


def test_grad_accum_micro_steps_match_reference(fits, micro_steps):
    """grad_accum_every 2 over four micro-steps, each from credit_tpu's
    state: after each, the step, the optimizer's count and mini-step equal
    credit_tpu's; on the first and third the parameters stay bitwise as
    they were, the running mean is the micro-step's gradient (as held by
    test_micro_step_gradients_match_reference) and the EMA mixes the
    unchanged parameters as credit_tpu's does (1e-5 lr); on the second and
    fourth the update and EMA are what credit_tpu's optimizer makes of the
    port's gradient (_check_update) and the running mean restarts."""
    conf = fits["conf"]
    for i, rec in enumerate(micro_steps):
        ms = rec["after"].opt_state
        assert rec["step"] == int(rec["after"].step) == i + 1
        assert rec["mini_step"] == int(ms.mini_step) == (i + 1) % 2
        assert rec["count"] == int(ms.gradient_step) == (i + 1) // 2
        if i % 2 == 0:
            want_ema = _port_tree(rec["after"], conf, "ema_params")
            for n, p in rec["params"].items():
                assert torch.equal(p, rec["params_before"][n]), (i, n)
                assert torch.equal(rec["acc"][n], rec["grad"][n]), (i, n)
                err = (rec["ema"][n] - want_ema[n]).abs()
                assert (err <= 1e-5 * LR + ULP2 * want_ema[n].abs()).all(), (i, n)
        else:
            _check_update(rec, fits)
            assert all(not a.any() for a in rec["acc"].values())


def test_sn_external_matches_reference(fits, micro_steps):
    """sn_external: before each micro-step credit_tpu's power_iter_spectral
    and the port's power_iter_model_ leave the same u/v (1e-6) from the
    same state, and the port's step leaves them bitwise as it found them
    (the in-step iteration is off); with n_iter = 2 (what a 2-step rollout
    epoch asks), from the states before micro-steps 0 and 2 (before and
    after the first update), the u/v agree too and differ from n_iter =
    1's."""
    jt, trainer, conf = fits["jt"], fits["trainer"], fits["conf"]
    for i, rec in enumerate(micro_steps):
        want = _port_tree(rec["before"], conf)
        assert sum(n.endswith((".u", ".v")) for n in rec["uv"]) > 20
        for n, b in rec["buffers"].items():
            assert torch.equal(b, rec["uv"][n]), (i, n)
            if n.endswith((".u", ".v")):
                np.testing.assert_allclose(b.numpy(), want[n].numpy(), rtol=0, atol=1e-6,
                                           err_msg=f"{i} {n}")
    for i in (0, 2):
        pre = micro_steps[i]["pre"]
        trainer.model.load_state_dict(_port_tree(pre, conf))
        power_iter_model_(trainer.model, 2)
        spectral = jt._sn_update(pre.params, pre.spectral, n_iter=2)
        want = _port_tree(pre.replace(spectral=spectral), conf)
        moved = 0.0
        for n, b in trainer.model.named_buffers():
            if n.endswith((".u", ".v")):
                np.testing.assert_allclose(b.numpy(), want[n].numpy(), rtol=0, atol=1e-6,
                                           err_msg=f"{i} {n}")
                moved = max(moved, (b - micro_steps[i]["uv"][n]).abs().max().item())
        assert moved > 1e-6, i


def test_resume_is_bitwise(env, fits, tmp_path):
    """The port's own noise (no replay), one batch an epoch, so that the
    checkpoint falls between the two micro-steps of an update: a 1-epoch
    ensemble fit, then run_training resumed for a second epoch, ends
    bitwise where an uninterrupted 2-epoch fit ends: parameters, u/v, EMA,
    the optimizer's moments, running mean and counts, and the noise
    generator's state; the checkpoint holds the half-accumulated mean, and
    the last log row matches but its seconds."""
    full = fit_conf(env, tmp_path / "full", batches_per_epoch=1)
    trainer = port_trainer(full)
    want = trainer.fit(port_state(trainer, env["variables"], full), seed=0)
    part = fit_conf(env, tmp_path / "part", batches_per_epoch=1, num_epoch=1)
    trainer1 = port_trainer(part)
    trainer1.fit(port_state(trainer1, env["variables"], part), seed=0)
    saved = torch.load(os.path.join(tmp_path / "part", "checkpoint", Trainer.CHECKPOINT_FILE),
                       weights_only=True)
    assert saved["noise"] is not None and saved["opt_state"]["mini_step"] == 1
    assert saved["opt_state"]["count"] == 0
    assert any(v.abs().sum() > 0 for v in saved["opt_state"]["acc"].values())
    resume = copy.deepcopy(part)
    resume["trainer"]["load_weights"] = True
    got = run_training(resume, device="cpu")
    assert got.step == want.step == 2
    for k, v in want.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], v), k
    for k, v in want.ema_params.items():
        assert torch.equal(got.ema_params[k], v), k
    for name in ("mu", "nu", "acc"):
        for k, v in want.opt_state[name].items():
            assert torch.equal(got.opt_state[name][k], v), (name, k)
    assert got.opt_state["count"] == want.opt_state["count"] == 1
    assert got.opt_state["mini_step"] == want.opt_state["mini_step"] == 0
    assert torch.equal(got.noise.get_state(), want.noise.get_state())
    rows, ref = _read_log(tmp_path / "part"), _read_log(tmp_path / "full")
    drop = ref[0].index("seconds")
    assert [c for i, c in enumerate(rows[-1]) if i != drop] == [
        c for i, c in enumerate(ref[2]) if i != drop]
    # the members differ: the generator's noise reaches the forecast
    x = torch.from_numpy(trainer.dataset.batch([0], 1)["x"])
    with torch.no_grad():
        a, b = (want.model(trainer.normalizer.normalize_input(x), generator=want.noise)
                for _ in range(2))
    assert not torch.equal(a, b)

"""Parity of the port's initial-condition optimization (`ic-opt`) and
precipitation-type classifier with credit_tpu's, f32 on the CPU.

ic-opt: the tiny CrossFormer of tests/test_torch_port_fit.py (credit_tpu's
with its converged spectral state, the port's folded from it), 10 Adam
iterations on x0 over a 2-step trajectory with forcing and a Tikhonov
pull: the losses and the optimized x0 within 1e-4 of credit_tpu's (relative
to the largest). ptype: weights written by credit_tpu's classifier as npz
and read by the port (and back), the fields within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu import ptype as jptype
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.grid import Grid as JGrid
from credit_tpu.trainers import ic_optimization as jicopt
from credit_torch import ptype
from credit_torch.convert_jax import from_jax_variables
from credit_torch.data.channels import ChannelSchema
from credit_torch.grid import Grid
from credit_torch.models import load_model
from credit_torch.trainers.ic_optimization import optimize_initial_condition
from credit_torch.trainers.trainer import load_trainer
# env is a fixture: imported, it applies here too
from tests.test_torch_port_fit import env  # noqa: F401
from torch_port_fixtures import fit_conf
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

H, W = 32, 64
ICOPT_TOL = 1e-4
TOL = 1e-5


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# --------------------------------------------------------------- ic-opt
def test_ic_opt_matches_reference(env, tmp_path):
    """optimize_initial_condition with n_steps 2 (the second step's input
    spliced with the forcing), lr 1e-2 and background_weight 0.5: the 10
    losses and x0 within 1e-4; the loss falls, x0 moves; the port's model
    is left as it was (parameters, their requires_grad, train mode), and
    load_trainer's ic-opt is this function."""
    conf = fit_conf(env["store"], env["stats"], tmp_path)
    jschema, schema = JSchema.from_config(conf), ChannelSchema.from_config(conf)
    x0 = _rand((1, 1, H, W, schema.n_input), 1)
    targets = _rand((1, 2, H, W, schema.n_target), 2, 0.5)
    forcing = _rand((1, 2, H, W, len(schema.dynamic_forcing_indices())), 3)
    kw = dict(n_steps=2, history_len=1, iterations=10, learning_rate=1e-2,
              background_weight=0.5)
    jvars = jax.tree_util.tree_map(jnp.asarray, env["variables"])
    jx, jlosses = jicopt.optimize_initial_condition(
        env["jmodel"], jvars, jschema, jnp.asarray(x0), jnp.asarray(targets),
        jnp.asarray(forcing), **kw)
    model = load_model(conf, device="cpu")
    model.load_state_dict(from_jax_variables(env["variables"], conf, device="cpu"))
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_trainer({"trainer": {"type": "ic-opt"}}) is optimize_initial_condition
    x, losses = optimize_initial_condition(model, schema, torch.from_numpy(x0),
                                           torch.from_numpy(targets), torch.from_numpy(forcing),
                                           device="cpu", **kw)
    _close(losses, jlosses, ICOPT_TOL, "losses")
    _close(x, jx, ICOPT_TOL, "x0")
    assert losses[-1] < losses[0] and (x - torch.from_numpy(x0)).abs().max() > 1e-3
    assert model.training and all(p.requires_grad for p in model.parameters())
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_ic_opt_default_loss_and_history(env, tmp_path):
    """Two input frames (history_len 2, the window shifted by one frame a
    step), no forcing, the default MSE and no pull, 3 iterations: against
    credit_tpu within 1e-4."""
    conf = fit_conf(env["store"], env["stats"], tmp_path)
    jschema, schema = JSchema.from_config(conf), ChannelSchema.from_config(conf)
    x0 = _rand((1, 2, H, W, schema.n_input), 4)
    targets = _rand((1, 3, H, W, schema.n_target), 5, 0.5)
    kw = dict(n_steps=3, history_len=2, iterations=3, learning_rate=5e-3)

    jvars = jax.tree_util.tree_map(jnp.asarray, env["variables"])

    def jmodel_last(x):  # the tiny model takes one frame: the newest
        return env["jmodel"].apply(jvars, x[:, -1:])

    jx, jlosses = jicopt.optimize_initial_condition(
        type("M", (), {"apply": staticmethod(lambda v, x: jmodel_last(x))}), None, jschema,
        jnp.asarray(x0), jnp.asarray(targets), **kw)
    model = load_model(conf, device="cpu")
    model.load_state_dict(from_jax_variables(env["variables"], conf, device="cpu"))

    class Last(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = model

        def forward(self, x):
            return self.inner(x[:, -1:])

    x, losses = optimize_initial_condition(Last(), schema, torch.from_numpy(x0),
                                           torch.from_numpy(targets), device="cpu", **kw)
    _close(losses, jlosses, ICOPT_TOL, "losses")
    _close(x, jx, ICOPT_TOL, "x0")


# --------------------------------------------------------------- ptype
def test_dewpoint_and_evidential_outputs_match_reference():
    rng = np.random.default_rng(0)
    q = rng.uniform(1e-5, 2e-2, (6, 7)).astype(np.float32)
    p = rng.uniform(3e4, 1.05e5, (6, 7)).astype(np.float32)
    _close(ptype.dewpoint_from_q(torch.from_numpy(q), torch.from_numpy(p)),
           jptype.dewpoint_from_q(jnp.asarray(q), jnp.asarray(p)), TOL)
    ev = np.abs(_rand((5, 4), 1, 3.0))
    ev[0] = 0.0
    got = ptype.evidential_outputs(torch.from_numpy(ev))
    want = jptype.evidential_outputs(jnp.asarray(ev))
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], TOL, k)


def _profiles(seed, shape=(4, 5, 3)):
    t = _rand(shape, seed, 10.0) + 270.0
    return t, t - np.abs(_rand(shape, seed + 1, 3.0))


@pytest.mark.parametrize("with_stats", [False, True])
def test_classifier_weights_carry_across(tmp_path, with_stats):
    """credit_tpu's classifier (hidden 8, 8; with the features' mean and
    std or without) saved as npz and read by the port, then saved by the
    port and read by credit_tpu: every ML_* field within 1e-5, the files'
    arrays equal."""
    stats = dict(mean=np.full(6, 265.0, np.float32), std=np.full(6, 12.0, np.float32)) \
        if with_stats else {}
    jclf = jptype.PTypeClassifier(hidden=(8, 8), **stats)
    jclf.init(jax.random.PRNGKey(0), n_features=6)
    jclf.save(str(tmp_path / "jax.npz"))
    clf = ptype.PTypeClassifier(weights_path=str(tmp_path / "jax.npz"), device="cpu")
    assert clf.hidden == (8, 8)
    t, td = _profiles(2)
    want = jclf(jnp.asarray(t), jnp.asarray(td))
    got = clf(torch.from_numpy(t), torch.from_numpy(td))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape == (4, 5)
        _close(got[k], want[k], TOL, k)
    clf.save(str(tmp_path / "port.npz"))
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    back = jptype.PTypeClassifier(weights_path=str(tmp_path / "port.npz"), hidden=(8, 8))
    _close(back(jnp.asarray(t), jnp.asarray(td))["ML_snow"], got["ML_snow"], TOL)


@pytest.mark.parametrize("hybrid", [False, True])
def test_classify_state_matches_reference(tmp_path, hybrid):
    """classify_state from a flat prediction: pressures from the grid's
    levels, or from SP and hybrid coefficients; the same weights on both
    sides; every field within 1e-5; the probabilities sum to 1 and the
    winners are one-hot."""
    conf = {"data": {"source": {"ERA5": {
        "levels": [30000.0, 70000.0, 100000.0],
        "variables": {"prognostic": {"vars_3D": ["T", "Q"], "vars_2D": ["SP"]}}}}}}
    schema, jschema = ChannelSchema.from_config(conf), JSchema.from_config(conf)
    hyb = dict(ak=[0.0, 2e4, 1e4, 0.0], bk=[0.0, 0.1, 0.6, 1.0]) if hybrid else {}
    grid = Grid.regular(4, 8, levels=[30000.0, 70000.0, 100000.0], **hyb)
    jgrid = JGrid.regular(4, 8, levels=[30000.0, 70000.0, 100000.0], **hyb)
    jclf = jptype.PTypeClassifier(hidden=(8,))
    jclf.init(jax.random.PRNGKey(1), n_features=6)
    jclf.save(str(tmp_path / "w.npz"))
    clf = ptype.PTypeClassifier(weights_path=str(tmp_path / "w.npz"), device="cpu")
    rng = np.random.default_rng(1)
    y = np.zeros((1, 1, 4, 8, schema.n_target), np.float32)
    for i, n in enumerate(schema.target_names):
        if n.startswith("T"):
            y[..., i] = rng.normal(270, 5, (4, 8))
        elif n.startswith("Q"):
            y[..., i] = rng.uniform(1e-4, 5e-3, (4, 8))
        else:
            y[..., i] = rng.uniform(9.5e4, 1.03e5, (4, 8))
    want = jclf.classify_state(jnp.asarray(y), jschema, jgrid)
    got = clf.classify_state(torch.from_numpy(y), schema, grid)
    for k in want:
        _close(got[k], want[k], TOL, k)
    probs = np.stack([got[f"ML_{p}"] for p in ptype.PTYPES], -1)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    onehot = np.stack([got[f"ML_c{p}"] for p in ptype.PTYPES], -1)
    assert set(np.unique(onehot)) <= {0.0, 1.0} and (onehot.sum(-1) == 1).all()


def test_seeded_classifier_and_refusals(tmp_path):
    """The port's seeded init (flax Dense's LeCun-normal kernels, zero
    biases) is reproducible from its generator; an untrained classifier
    raises; the card is the default device."""
    a = ptype.PTypeClassifier(hidden=(16,), device="cpu")
    with pytest.raises(RuntimeError, match="no weights"):
        a(np.zeros((2, 3), np.float32), np.zeros((2, 3), np.float32))
    a.init(torch.Generator().manual_seed(3), 6)
    b = ptype.PTypeClassifier(hidden=(16,), device="cpu")
    b.init(torch.Generator().manual_seed(3), 6)
    w = a.net.hidden[0].weight
    assert torch.equal(w, b.net.hidden[0].weight) and not a.net.evidence.bias.any()
    std = 6**-0.5 / 0.87962566103423978  # LeCun normal's, before the truncation
    assert abs(float(w.std()) - 6**-0.5) < 0.1 and float(w.abs().max()) <= 2 * std
    t, td = _profiles(4)
    out = a(t, td)
    np.testing.assert_allclose(sum(out[f"ML_{p}"] for p in ptype.PTYPES), 1.0, rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ptype.PTypeClassifier()

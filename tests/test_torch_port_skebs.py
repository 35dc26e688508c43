"""Parity of the port's SKEBS and stateful postblock path with credit_tpu:
the pattern (physics/skebs.py), the six backscatter nets
(physics/skebs_nets.py), the `skebs` block and the stateful pipeline
(postblock/stochastic.py), the train and eval steps with a learned
backscatter net, RolloutEngine carrying the pattern, the checkpoint and
the converter carrying the nets.

credit_tpu draws its SKEBS noise from JAX keys (normal(kr) + 1j
normal(ki) for each cycle) and its model noise from flax's 'noise'
stream. These tests compute the draws each key gives and replay them in
the port (`SKEBS.cycle(..., noise=)` through a wrapper, the model's
`forward(noise=)` as tests/test_torch_port_ensemble.py does), in the order
credit_tpu makes them. The same numpy weights go to both packages, f32 on
the CPU.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from __graft_entry__ import TINY_MODEL_CONF
from credit_tpu import losses as jlosses
from credit_tpu import postblock as jpb
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.data.normalize import Normalizer as JNormalizer
from credit_tpu.grid import Grid as JGrid
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.models.spectral_utils import converge_spectral
from credit_tpu.physics import skebs as jskebs
from credit_tpu.physics import skebs_nets as jnets
from credit_tpu.postblock import stochastic as jst
from credit_tpu.rollout import RolloutEngine as JRolloutEngine
from credit_tpu.trainers import trainer as jtrainer
from credit_torch import losses as tlosses
from credit_torch import postblock as tpb
from credit_torch.convert_jax import from_jax_variables, postblocks_from_jax
from credit_torch.data.channels import ChannelSchema
from credit_torch.data.normalize import Normalizer
from credit_torch.data.synthetic import SyntheticDataset
from credit_torch.grid import Grid
from credit_torch.models import load_model
from credit_torch.physics import skebs as tskebs
from credit_torch.physics import skebs_nets as tnets
from credit_torch.postblock import stochastic as tst
from credit_torch.rollout import RolloutEngine
from credit_torch.trainers import trainer as ttrainer
from credit_torch.utils.ncio import open_dataset
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

TOL = 1e-5
NLEV = 2
FILTERS = {"max_pattern_wavenum": 8, "pattern_filter_anneal_start": 4,
           "max_backscatter_wavenum": 12, "backscatter_filter_anneal_start": 8}
DATA = {"source": {"ERA5": {
    "levels": list(range(NLEV)),
    "variables": {"prognostic": {"vars_3D": ["U", "V", "T"], "vars_2D": ["SP", "U10", "V10"]},
                  "dynamic_forcing": {"vars_2D": ["TISR"]},
                  "diagnostic": {"vars_2D": ["PRECIP"]}}}}}
STATS = {"U": (2.0, 10.0), "V": (0.0, 8.0), "T": (260.0, 20.0), "SP": (1e5, 1000.0),
         "U10": (2.0, 6.0), "V10": (0.0, 5.0), "TISR": (300.0, 150.0), "PRECIP": (1e-4, 5e-4)}


def _rel(got, want) -> float:
    """max |got - want| over max |want| (complex or real)."""
    got, want = np.asarray(got).astype(np.complex128), np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _schema_conf(h=16, w=32):
    conf = copy.deepcopy(TINY_MODEL_CONF)
    conf["model"].update(image_height=h, image_width=w, levels=NLEV, channels=3,
                         surface_channels=3, input_only_channels=1, output_only_channels=1)
    return {**conf, "data": DATA}


def _physical(schema, rng, shape, entries):
    arr = np.zeros(shape, np.float32)
    for e in entries:
        m, s = STATS[e.name.rpartition("_L")[0] or e.name]
        arr[..., e.index] = m + s * rng.standard_normal(shape[:-1])
    return arr


def _norms(jschema, schema):
    mean = {k: m for k, (m, _) in STATS.items()}
    std = {k: s for k, (_, s) in STATS.items()}
    return (JNormalizer.from_stats_dict(jschema, mean, std),
            Normalizer.from_stats_dict(schema, mean, std))


def _jit(fn):
    """jax.jit at XLA's lowest optimisation level: these programs run once
    or twice, and compiling them dominates (the numbers are the same ops')."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    cache = {}

    def call(*args):
        key = str(jax.tree_util.tree_structure(args)) + str(
            [getattr(a, "shape", None) for a in jax.tree_util.tree_leaves(args)])
        if key not in cache:
            cache[key] = jax.jit(fn).lower(*args).compile(compiler_options=opts)
        return cache[key](*args)

    return call


def _numpy_params(init, *args, seed=0):
    """A flax parameter tree of init(*args)'s shapes (jax.eval_shape: no
    compile) drawn with numpy: kernels N(0, 1/fan_in), biases small,
    columns around 2.5."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        if "backscatter_array" in name:
            return rng.uniform(1.0, 4.0, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init, *args))


# --------------------------------------------------------------- draws
def _draw(key, shape):
    """The complex noise credit_tpu's SKEBS.cycle draws from `key`."""
    kr, ki = jax.random.split(key)
    return np.array(jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape),
                    np.complex64)


def _init_draws(shape, key=None):
    """init_state's five draws (credit_tpu's blocks spin up from PRNGKey(0))."""
    key = jax.random.PRNGKey(0) if key is None else key
    out = []
    for _ in range(5):
        key, sub = jax.random.split(key)
        out.append(_draw(sub, shape))
    return out


def _stateful_key(post_key):
    """The key the first stateful block gets in apply_postblocks_stateful."""
    return jax.random.split(post_key)[1]


def _step_keys(rng):
    """(model noise key, postblock key) of rollout step 0 in credit_tpu's
    train and eval steps."""
    rng, sub = jax.random.split(rng)
    _, post_key = jax.random.split(rng)
    return sub, post_key


def replay_skebs(block, draws):
    """Make the port's block cycle with `draws` (in call order)."""
    cycle, queue = block.skebs.cycle, [torch.from_numpy(d) for d in draws]

    def replayed(coef, generator=None, noise=None):
        return cycle(coef, generator, noise=queue.pop(0) if noise is None else noise)

    block.skebs.cycle = replayed
    return queue


# --------------------------------------------------------------- SKEBS
def test_skebs_pattern_matches_reference():
    """SKEBS.init_state and two cycles with credit_tpu's draws replayed,
    and perturb_winds at a prescribed rate: within 1e-5 of the reference's
    largest value. The filters and the clipped parameters are credit_tpu's
    bitwise. The port's own draws have real and imaginary parts of unit
    variance each, as normal(kr) + 1j normal(ki) (torch's complex normal
    would give 1/2)."""
    kw = dict(FILTERS, lmax=12, mmax=10)
    params = jskebs.SKEBSParams(alpha=2.0, p=0.5, dE=0.3)
    ours = tskebs.SKEBS(Grid.regular(16, 32), tskebs.SKEBSParams(alpha=2.0, p=0.5, dE=0.3), **kw)
    ref = jskebs.SKEBS(JGrid.regular(16, 32), params, **kw)
    assert ours.params == tskebs.SKEBSParams(**vars(ref.params))
    for name in ("pattern_filter", "backscatter_filter", "lrange"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))
    shape = (3, 12, 10)
    key = jax.random.PRNGKey(5)
    draws = _init_draws(shape, key) + [_draw(jax.random.PRNGKey(s), shape) for s in (6, 7)]
    replay_skebs(type("B", (), {"skebs": ours})(), draws)
    want = ref.init_state(key, 3)  # op by op: its draws' primitives are compiled already
    got = ours.init_state(None, 3)
    assert got.dtype == torch.complex64 and _rel(got.numpy(), want) < TOL
    for s in (6, 7):
        want = ref.cycle(want, jax.random.PRNGKey(s))
        got = ours.cycle(got)
        assert _rel(got.numpy(), want) < TOL
    u = np.random.default_rng(0).standard_normal((3, NLEV, 16, 32)).astype(np.float32)
    ju, jv, jc = _jit(ref.perturb_winds)(u, -u, want, jax.random.PRNGKey(9))
    tu, tv, tc = ours.perturb_winds(torch.from_numpy(u), torch.from_numpy(-u), got,
                                    noise=torch.from_numpy(_draw(jax.random.PRNGKey(9), shape)))
    for a, b in ((tu, ju), (tv, jv), (tc, jc)):
        assert _rel(a.numpy(), b) < TOL
    assert _rel(np.asarray(ju), u) > 1e-6
    noise = ours.noise((200, 1000), torch.Generator().manual_seed(0), "cpu")
    assert abs(float(noise.real.var()) - 1) < 0.02 and abs(float(noise.imag.var()) - 1) < 0.02


NETS = {"fcnn": {}, "fcnn_wide": {}, "cnn": {}, "unet": {"width": 4}, "fixed_column": {},
        "prescribed": {"profile": [1.5, 3.0]}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.mark.parametrize("kind", sorted(NETS))
def test_backscatter_nets_match_reference(kind):
    """Each skebs_net on a 17x30 grid of 5 channels (the U-Net pads it to
    20x32) with credit_tpu's flax parameters renamed: within 1e-5 of the
    reference's largest value, non-negative. The port's own init is flax's:
    the same parameter names and shapes, biases 0, kernels lecun-normal
    truncated at two deviations, columns 2.5 or the profile."""
    x = np.random.default_rng(1).standard_normal((2, 17, 30, 5)).astype(np.float32)
    jnet = jnets.build_backscatter_net({"type": kind, **NETS[kind]}, NLEV)
    jp = _numpy_params(jnet.init, jax.random.PRNGKey(2), x, seed=2)["params"]
    want = np.asarray(_jit(lambda p, x: jnet.apply({"params": p}, x))(jp, x))
    net = tnets.build_backscatter_net({"type": kind, **NETS[kind]}, NLEV, 5)
    flat = _flat(jax.device_get(jp))
    assert {k: v.shape for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in net.state_dict().items()}
    net.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 17, 30, NLEV) and (got >= 0).all()
    assert _rel(got, want) < TOL
    tnets.init_(net, torch.Generator().manual_seed(0))
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            assert not p.any()
        elif name.endswith("kernel"):
            std = np.sqrt(1.0 / np.prod(p.shape[:-1])) / 0.87962566103423978
            assert 0 < float(p.detach().abs().max()) <= 2 * std
        else:
            want = NETS[kind].get("profile", 2.5)
            np.testing.assert_array_equal(p.detach().numpy(), np.broadcast_to(want, p.shape))


SKEBS_CASES = {
    "iteration_stop": {"backscatter": 4e-5, "iteration_stop": 1},
    "winds_2d": {"backscatter_net": {"type": "cnn"}, "U_var": "U10", "V_var": "V10"},
    **{f"net_{k}": {"backscatter_net": {"type": k, **v}, "dissipation_scaling": 1e-4}
       for k, v in NETS.items()},
}


@pytest.mark.parametrize("case", sorted(SKEBS_CASES))
def test_skebs_block_matches_reference(case):
    """The `skebs` block built by build_postblocks from credit_tpu's
    config (16x32, 2 levels, lmax 16): a prescribed rate with
    iteration_stop 1, a learned cnn rate on the 2-D winds (averaged over
    the levels), and each of the six nets on U and V; two steps with the
    state carried and credit_tpu's draws replayed, the net's parameters
    credit_tpu's flax ones renamed (`postblocks_from_jax`): the winds
    within 1e-5 of the reference's largest value, every other channel
    bitwise untouched; the iteration counter counts, and with
    iteration_stop 1 the second step leaves the winds as they came."""
    conf = _schema_conf()
    jschema, schema = JSchema.from_config(conf), ChannelSchema.from_config(conf)
    post = {"post_conf": {"activate": True,
                          "skebs": {"activate": True, **FILTERS, **SKEBS_CASES[case]}}}
    (ours,) = tpb.build_postblocks(post, schema, Grid.regular(16, 32))
    (ref,) = jpb.build_postblocks(post, jschema, JGrid.regular(16, 32))
    rng = np.random.default_rng(3)
    x = _physical(schema, rng, (2, 1, 16, 32, schema.n_input), schema.input_entries)
    y = _physical(schema, rng, (2, 1, 16, 32, schema.n_target), schema.target_entries)
    jp = None if ref.net is None else _numpy_params(ref.init_params, jax.random.PRNGKey(4), x,
                                                     seed=4)
    params = None
    if jp is not None:
        params = tst.split_postblock_params(postblocks_from_jax({"0": jax.device_get(jp)},
                                                                 device="cpu"))["0"]
        ours.net.load_state_dict(params)
    shape = (2, 16, 16)
    keys = [jax.random.PRNGKey(10 + s) for s in range(2)]
    # both start from the port's spun-up pattern (init_state's draws:
    # test_skebs_pattern_matches_reference), then cycle with the keys' draws
    state = ours.init_state(2)
    jstate = (state[0].numpy(), np.zeros((), np.int32))
    assert int(state[1]) == 0
    replay_skebs(ours, [_draw(k, shape) for k in keys])
    step = _jit(lambda y_, x_, st, k, p: ref(y_, x_, st, k, **({"net_params": p} if p else {})))
    wind = [i for i, n in enumerate(schema.target_names)
            if n.rpartition("_L")[0] in ("U", "V") or n in ("U10", "V10")]
    jy, ty = y, torch.from_numpy(y)
    for s, k in enumerate(keys):
        jy, jstate = step(jy, x, jstate, k, jp)
        with torch.no_grad():
            ty, state = ours(ty, torch.from_numpy(x), state, None, **(
                {"net_params": params} if params else {}))
        want, got = np.asarray(jy), ty.numpy()
        moved = np.abs(want - y).max(axis=(0, 1, 2, 3)) > 0
        assert int(state[1]) == s + 1
        if case == "iteration_stop" and s == 1:  # shut off: the winds as they came
            np.testing.assert_array_equal(want, y)
            np.testing.assert_array_equal(got, y)
            continue
        assert moved.any() and set(np.flatnonzero(moved)) <= set(wind)
        np.testing.assert_array_equal(got[..., ~moved], y[..., ~moved])
        assert _rel(got[..., moved], want[..., moved]) < TOL, s
        y = want


def test_stateful_pipeline_matches_reference():
    """apply_postblocks_stateful over Denorm, the tracer fixer, `skebs`
    with a learned cnn rate and Renorm (the index of the trainable block,
    2, keys its net as credit_tpu keys params['_postblocks']), two steps:
    the prediction within 1e-5 per channel of credit_tpu's pipeline with
    its keys, both from the port's spun-up pattern; init_postblock_states
    keys the states by index, init_postblock_params seeds the net in
    place and returns it under '2', and split_postblock_params reads
    `_postblocks.<i>.<name>`."""
    conf = _schema_conf()
    jschema, schema = JSchema.from_config(conf), ChannelSchema.from_config(conf)
    jn, tn = _norms(jschema, schema)
    post = {"post_conf": {"activate": True, "tracer_fixer": {
        "activate": True, "tracer_vars": ["T"], "tracer_thres": 250.0},
        "skebs": {"activate": True, "backscatter_net": {"type": "cnn"}, **FILTERS}}}
    ours = tpb.build_postblocks(post, schema, Grid.regular(16, 32), tn)
    ref = jpb.build_postblocks(post, jschema, JGrid.regular(16, 32), jn)
    assert [type(b).__name__ for b in ours] == [type(b).__name__ for b in ref] == [
        "Denorm", "TracerFixer", "SKEBSPostblock", "Renorm"]
    rng = np.random.default_rng(5)
    x = np.array(jn.normalize_input(_physical(
        schema, rng, (2, 1, 16, 32, schema.n_input), schema.input_entries)))
    y = np.array(jn.normalize_target(_physical(
        schema, rng, (2, 1, 16, 32, schema.n_target), schema.target_entries)))
    nets = tst.init_postblock_params(ours, torch.Generator().manual_seed(0), "cpu")
    assert list(nets) == ["2"] and nets["2"] is ours[2].net and nets["2"].conv.kernel.any()
    jparams = {"2": _numpy_params(lambda k, x_: ref[2].init_params(k, x_), jax.random.PRNGKey(1),
                                  x, seed=1)}
    flat = postblocks_from_jax(jax.device_get(jparams), device="cpu")
    assert sorted(flat) == ["_postblocks.2.conv.bias", "_postblocks.2.conv.kernel"]
    params = tst.split_postblock_params({**flat, "other.weight": torch.zeros(1)})
    assert list(params) == ["2"]
    shape = (2, 16, 16)
    keys = [jax.random.PRNGKey(20 + s) for s in range(2)]
    states = tst.init_postblock_states(ours, 2)
    assert list(states) == [2]
    jstates = {2: (states[2][0].numpy(), np.zeros((), np.int32))}
    replay_skebs(ours[2], [_draw(_stateful_key(k), shape) for k in keys])
    run = _jit(lambda y_, x_, st, k, p: jst.apply_postblocks_stateful(ref, y_, x_, st, k,
                                                                      params=p))
    jy, ty = y, torch.from_numpy(y)
    for k in keys:
        jy, jstates = run(jy, x, jstates, k, jparams)
        with torch.no_grad():
            ty, states = tst.apply_postblocks_stateful(ours, ty, torch.from_numpy(x), states,
                                                       None, params)
        err = np.abs(ty.numpy() - np.asarray(jy)).max(axis=(0, 1, 2, 3))
        assert (err <= TOL * np.abs(np.asarray(jy)).max(axis=(0, 1, 2, 3))).all()
    assert int(states[2][1]) == 2


# --------------------------------------------------------------- steps
E = 2


def _numpy_variables(model, x, seed: int):
    """The JAX model's parameters and spectral state drawn with numpy
    (kernels he_uniform, scales and modulations near 1, u/v converged, the
    rest small normals)."""
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
    """draw(key, shape) -> the model noise credit_tpu draws from `key` for an
    input of `shape`: {"latent": ..., <layer>: pixel noise}."""
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

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

    capture = _jit(capture)

    def draw(key, shape):
        latent, pixels = capture(key, np.zeros(shape, np.float32))
        return {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in {"latent": latent, **pixels}.items()}

    return draw


def replay_model(model, draws):
    """The port's model takes its noise from `draws`, one dict per forward."""
    forward, queue = type(model).forward, list(draws)

    def replayed(x, noise=None, generator=None):
        return forward(model, x, noise=queue.pop(0))

    model.forward = replayed
    return queue


@pytest.fixture(scope="module")
def steps_env():
    """TINY_MODEL_CONF as crossformer-ensemble without its transformer
    blocks (depth 0: the cross-embed convs, the up-blocks and the SDL noise
    layers, whose backward tests/test_torch_port_ensemble_fit.py holds with
    the blocks), 32x64, U V T on 2 levels, with a Normalizer and `skebs`
    with a learned cnn rate, the almost-fair CRPS; numpy weights for both
    packages, the cnn's from credit_tpu's init. (No tracer fixer: credit_tpu's
    jitted CRPS gradient behind it is wrong on XLA:CPU, ROADMAP queue 3.)"""
    conf = _schema_conf(32, 64)
    conf["model"].update(type="crossformer-ensemble", depth=[0, 0, 0, 0])
    conf["model"]["post_conf"] = {
        "activate": True,
        "skebs": {"activate": True, "backscatter_net": {"type": "cnn"}, **FILTERS}}
    conf["loss"] = {"training_loss": "almost-fair-crps", "validation_loss": "almost-fair-crps"}
    jschema, schema = JSchema.from_config(conf), ChannelSchema.from_config(conf)
    jn, tn = _norms(jschema, schema)
    jmodel = jax_load_model(conf)
    shape = (E, 1, 32, 64, schema.n_input)
    variables = _numpy_variables(jmodel, np.zeros(shape, np.float32), 3)
    jblocks = jpb.build_postblocks(conf, jschema, JGrid.regular(32, 64), jn)
    x_sample = np.zeros(shape, np.float32)
    netp = {"1": _numpy_params(jblocks[1].init_params, jax.random.PRNGKey(8), x_sample, seed=8)}
    rng = np.random.default_rng(9)
    batch = {"x": _physical(schema, rng, (1, 1, 32, 64, schema.n_input), schema.input_entries),
             "y": _physical(schema, rng, (1, 1, 32, 64, schema.n_target),
                            schema.target_entries)}
    return {"conf": conf, "jschema": jschema, "schema": schema, "jn": jn, "tn": tn,
            "jmodel": jmodel, "variables": variables, "netp": netp, "jblocks": jblocks,
            "batch": batch, "shape": shape, "draw": _noise_drawer(jmodel, variables)}


def _grad_capture():
    """An optax transformation that applies nothing and keeps the gradient
    it is given as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


class _GradRecorder:
    """The port's counterpart: records the gradients, returns no update."""

    def init(self, params):
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()}, "count": 0}

    def update(self, grads, state, params):
        self.grads = {k: g.clone() for k, g in zip(state["mu"], grads)}
        return None, state


def _port_side(env, ema=False):
    conf, schema, tn = env["conf"], env["schema"], env["tn"]
    model = load_model(conf, device="cpu", sn_state=True)
    model.load_state_dict(from_jax_variables(env["variables"], conf, device="cpu", fold=False))
    blocks = tpb.build_postblocks(conf, schema, Grid.regular(32, 64), tn)
    nets = tst.postblock_nets(blocks)
    flat = postblocks_from_jax(env["netp"], device="cpu")
    nets.load_state_dict({k[len("_postblocks."):]: v for k, v in flat.items()})
    rec = _GradRecorder()
    state = ttrainer.TrainState.create(model, rec, ema=ema, nets=nets)
    return model, blocks, rec, state


def _replay_step(env, model, blocks, key):
    """Replay the model and SKEBS draws of rollout step 0 of credit_tpu's
    train or eval step with `key`."""
    noise_key, post_key = _step_keys(key)
    replay_model(model, [env["draw"](noise_key, env["shape"])])
    sk = (E, 32, 32)
    replay_skebs(blocks[1], _init_draws(sk) + [_draw(_stateful_key(post_key), sk)])


def test_train_step_matches_reference(steps_env):
    """One train step (2 members of 1 sample) with the SDL and the SKEBS
    noise replayed, against credit_tpu's jitted make_train_step given the
    same weights and key: the loss within 1e-5; the gradient of every model
    parameter and of the backscatter net's kernel and bias (the state's
    `_postblocks.1.conv.*`, credit_tpu's params['_postblocks']['1']) within
    1e-4 of its leaf's largest value or 1e-5 of the whole gradient's norm,
    the net's gradient nonzero; the state's nets are the blocks', and the
    step leaves every parameter as it was (the recorder applies nothing)."""
    env = steps_env
    conf, jschema, schema = env["conf"], env["jschema"], env["schema"]
    jloss = jlosses.WeightedLoss.from_config(conf, JGrid.regular(32, 64))
    jstep = _jit(jtrainer.make_train_step(
        env["jmodel"], jloss, _grad_capture(), jschema, ensemble_size=E, normalizer=env["jn"],
        postblocks=tuple(env["jblocks"])))
    params = {**env["variables"]["params"], "_postblocks": env["netp"]}
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 spectral=env["variables"]["spectral"],
                                 opt_state=_grad_capture().init(params), ema_params=None)
    key = jax.random.PRNGKey(31)
    jnew, jm = jstep(jstate, env["batch"], key)
    jgrads = _flat(jax.device_get(jnew.opt_state))

    model, blocks, rec, state = _port_side(env)
    _replay_step(env, model, blocks, key)
    before = {k: v.detach().clone() for k, v in state.named_parameters().items()}
    step = ttrainer.make_train_step(model, tlosses.WeightedLoss.from_config(conf, Grid.regular(
        32, 64)), rec, schema, ensemble_size=E, normalizer=env["tn"], postblocks=tuple(blocks),
        device="cpu")
    state, m = step(state, {k: torch.from_numpy(v) for k, v in env["batch"].items()})
    assert state.nets["1"] is blocks[1].net
    assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
    assert set(jgrads) == set(rec.grads), sorted(set(jgrads) ^ set(rec.grads))
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in rec.grads.values()))
    for name, want in jgrads.items():
        err = np.abs(rec.grads[name].numpy() - want).max()
        assert err <= max(1e-4 * np.abs(want).max(), 1e-5 * norm), (name, err)
    assert float(rec.grads["_postblocks.1.conv.kernel"].abs().max()) > 0
    for k, v in state.named_parameters().items():
        assert torch.equal(v, before[k]), k


def test_eval_step_matches_reference(steps_env):
    """One eval step (2 members) on EMA weights 1.01 times the parameters,
    the net's included (credit_tpu's params['_postblocks'] in its EMA), with
    the noise replayed: the loss within 1e-5 of credit_tpu's make_eval_step;
    the EMA's copy of the net is what runs (scaling the live net changes
    nothing)."""
    env = steps_env
    conf, jschema, schema = env["conf"], env["jschema"], env["schema"]
    jloss = jlosses.WeightedLoss.from_config(conf, JGrid.regular(32, 64), validation=True)
    jeval = _jit(jtrainer.make_eval_step(
        env["jmodel"], jloss, jschema, normalizer=env["jn"], ensemble_size=E,
        postblocks=tuple(env["jblocks"])))
    params = {**env["variables"]["params"], "_postblocks": env["netp"]}
    ema = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.01, params)
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 spectral=env["variables"]["spectral"], opt_state=(),
                                 ema_params=ema)
    key = jax.random.PRNGKey(41)
    jm = jeval(jstate, env["batch"], key)

    model, blocks, _, state = _port_side(env, ema=True)
    with torch.no_grad():
        for v in state.ema_params.values():
            v.mul_(1.01)
    step = ttrainer.make_eval_step(
        model, tlosses.WeightedLoss.from_config(conf, Grid.regular(32, 64), validation=True),
        schema, normalizer=env["tn"], ensemble_size=E, postblocks=tuple(blocks), device="cpu")
    losses = []
    for scale in (1.0, 2.0):
        with torch.no_grad():
            for p in state.nets.parameters():
                p.mul_(scale)
        _replay_step(env, model, blocks, key)
        batch = {k: torch.from_numpy(v) for k, v in env["batch"].items()}
        losses.append(float(step(state, batch, torch.Generator())["loss"]))
    assert abs(losses[0] - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
    assert losses[1] == losses[0]


class _Echo(torch.nn.Module):
    """credit_tpu's `debugger` model (one frame): a 1x1 projection."""

    def __init__(self, kernel, bias):
        super().__init__()
        self.kernel, self.bias = torch.from_numpy(kernel), torch.from_numpy(bias)

    def forward(self, x):
        return x @ self.kernel + self.bias


def test_rollout_engine_matches_reference(steps_env, tmp_path):
    """RolloutEngine for 3 steps with the Normalizer and `skebs` (the
    learned cnn, its tensors split off the weights as a checkpoint holds
    them, `_postblocks.1.*`; write_rollout_debug_files on), the pattern
    carried from step to step, against credit_tpu's engine with the same
    weights and keys (its draws replayed), the model credit_tpu's
    `debugger` (a 1x1 projection, the same on both sides): every
    prediction within 1e-5 per channel, each step's
    debug_skebs/skebs_NNNN.nc within 1e-5 of credit_tpu's, and the
    pattern carried: consecutive steps' perturbation winds correlated
    above 0.8 (an AR(1) with alpha 0.05 reads ~0.9; a pattern drawn afresh
    each step ~0), their stream functions above 0.5 (degree 1 holds most
    of a stream function's variance, so its correlation over these few
    modes spreads from ~0.7 to ~1 with the draws)."""
    from credit_tpu.models.debugger import DebuggerModel

    env = steps_env
    jschema, schema = env["jschema"], env["schema"]
    confs = {}
    for side in ("ref", "port"):
        confs[side] = copy.deepcopy(env["conf"])
        confs[side]["model"]["post_conf"]["skebs"].update(write_rollout_debug_files=True,
                                                          save_loc=str(tmp_path / side))
    x0 = env["batch"]["x"]
    jmodel = DebuggerModel(image_height=32, image_width=64, channels=3, surface_channels=3,
                           input_only_channels=1, output_only_channels=1, levels=NLEV)
    rng = np.random.default_rng(12)
    kernel = (0.3 * rng.standard_normal((schema.n_input, schema.n_target))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(schema.n_target)).astype(np.float32)
    jvars = {"params": {"proj": {"kernel": kernel, "bias": bias}, "_postblocks": env["netp"]}}
    jblocks = jpb.build_postblocks(confs["ref"], jschema, JGrid.regular(32, 64), env["jn"])
    ref = JRolloutEngine(jmodel, jvars, jschema, env["jn"], postblocks=jblocks).run(x0, 3)

    blocks = tpb.build_postblocks(confs["port"], schema, Grid.regular(32, 64), env["tn"])
    key, draws, sk = jax.random.PRNGKey(0), [], (1, 32, 32)
    for _ in range(3):  # the engine's keys: each step's postblock key, then the block's
        key, sub = jax.random.split(key)
        post_key, _ = jax.random.split(sub)
        draws.append(_draw(_stateful_key(post_key), sk))
    replay_skebs(blocks[1], _init_draws(sk) + draws)
    engine = RolloutEngine(_Echo(kernel, bias), schema, env["tn"], postblocks=blocks,
                           postblock_params=postblocks_from_jax(env["netp"], device="cpu"),
                           device="cpu")
    got = engine.run(torch.from_numpy(x0), 3)
    engine.close()
    for g, r in zip(got, ref):
        err = np.abs(g - r).max(axis=(0, 1, 2, 3))
        assert (err <= TOL * np.abs(r).max(axis=(0, 1, 2, 3))).all()
    files = sorted(os.listdir(tmp_path / "port" / "debug_skebs"))
    assert files == sorted(os.listdir(tmp_path / "ref" / "debug_skebs")) == [
        f"skebs_{s:04d}.nc" for s in range(3)]
    fields = {v: [] for v in ("psi_pattern", "pert_u", "pert_v")}
    for f in files:
        a, b = (open_dataset(str(tmp_path / side / "debug_skebs" / f)) for side in ("port", "ref"))
        for v in fields:
            assert a[v].values.shape == (1, 32, 64)
            assert _rel(a[v].values, b[v].values) < TOL, (f, v)
            fields[v].append(np.asarray(a[v].values).ravel())
    corr = {v: [np.corrcoef(p, q)[0, 1] for p, q in zip(f, f[1:])] for v, f in fields.items()}
    assert min(corr["pert_u"] + corr["pert_v"]) > 0.8 and min(corr["psi_pattern"]) > 0.5, corr


def test_checkpoint_and_converter_carry_the_nets(steps_env, tmp_path):
    """A Trainer with `skebs` and a learned fcnn rate on a synthetic
    dataset: init_state seeds the net from its generator on the trainer's
    device (nonzero, the state's nets the blocks'), the optimizer and the
    EMA name its parameters `_postblocks.0.*` (no Normalizer: the block is
    the pipeline's first), save_checkpoint writes them
    beside the model's and load_checkpoint reads them back into a fresh
    trainer bitwise; from_jax_variables leaves params['_postblocks'] to
    postblocks_from_jax, which renames it."""
    conf = _schema_conf(16, 32)
    conf["model"]["post_conf"] = {"activate": True, "skebs": {
        "activate": True, "backscatter_net": {"type": "fcnn"}, **FILTERS}}
    conf["trainer"] = {"use_ema": True, "learning_rate": 1e-3}
    conf["save_loc"] = str(tmp_path)
    schema = ChannelSchema.from_config(conf)
    grid = Grid.regular(16, 32)
    dataset = SyntheticDataset(schema, grid, n_times=8)

    def trainer():
        model = load_model(conf, device="cpu", sn_state=True)
        loss = tlosses.WeightedLoss()
        return ttrainer.Trainer(conf, model, loss, loss, schema, dataset, device="cpu")

    t1 = trainer()
    assert list(t1.nets) == ["0"] and t1.nets["0"] is t1.train_postblocks[0].net
    state = t1.init_state(torch.Generator().manual_seed(3))
    names = [k for k in state.opt_state["mu"] if k.startswith("_postblocks.")]
    assert names == ["_postblocks.0.fc1.kernel", "_postblocks.0.fc1.bias",
                     "_postblocks.0.fc2.kernel", "_postblocks.0.fc2.bias"]
    assert set(names) <= set(state.ema_params) and state.nets["0"].fc1.kernel.any()
    with torch.no_grad():
        for p in state.nets.parameters():
            p.add_(0.5)
    t1.save_checkpoint(state, 0)
    saved = torch.load(os.path.join(str(tmp_path), "checkpoint", "state.pt"), weights_only=True)
    assert set(names) <= set(saved["model"])
    t2 = trainer()
    fresh = ttrainer.TrainState.create(t2.model, t2.optimizer, ema=True, nets=t2.nets)
    assert not fresh.nets["0"].fc1.kernel.any()
    loaded = t2.load_checkpoint(fresh)
    for k, v in state.named_parameters().items():
        assert torch.equal(loaded.named_parameters()[k], v), k
    for k in names:
        assert torch.equal(loaded.ema_params[k], state.ema_params[k])

    jconf, variables = steps_env["conf"], steps_env["variables"]
    pb = {"1": {"fc1": {"kernel": np.ones((3, 2), np.float32), "bias": np.zeros(2, np.float32)}}}
    tree = {"params": {**variables["params"], "_postblocks": pb},
            "spectral": variables["spectral"]}
    folded = from_jax_variables(tree, jconf, device="cpu")
    assert not any(k.startswith("_postblocks") for k in folded)
    assert folded.keys() == from_jax_variables(variables, jconf, device="cpu").keys()
    flat = postblocks_from_jax(pb, device="cpu")
    assert sorted(flat) == ["_postblocks.1.fc1.bias", "_postblocks.1.fc1.kernel"]
    np.testing.assert_array_equal(flat["_postblocks.1.fc1.kernel"].numpy(), 1.0)

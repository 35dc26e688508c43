"""Parity of the PyTorch port's CrossFormer and rollout with credit_tpu, and
the port's import hygiene.

A JAX CrossFormer is initialised, its spectral norm converged, and its
variables bridged into the port (credit_torch.convert_jax); both then run
the same numpy input on the CPU. The port's kernels run their plain
PyTorch versions here; on CPU the JAX model takes its XLA composition.
"""

import ast
import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import TINY_MODEL_CONF
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.data.normalize import Normalizer as JNormalizer
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.models.scan_utils import stack_block_params
from credit_tpu.models.spectral_utils import converge_spectral, fold_spectral
from credit_tpu.rollout import make_scan_rollout as jax_scan_rollout
from credit_torch.convert_jax import from_jax_variables, init_folded, init_train
from credit_torch.data.channels import ChannelSchema
from credit_torch.data.normalize import Normalizer
from credit_torch.models import load_model
from credit_torch.losses import WeightedLoss
from credit_torch.rollout import RolloutEngine, make_scan_rollout
from credit_torch.trainers.scheduler import constant
from credit_torch.trainers.trainer import make_optimizer, make_train_step
from credit_torch.utils.ncio import Dataset
from torch_port_fixtures import jit_lowopt, two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# TINY_MODEL_CONF covers the padded embed form ([4, 8]); the second config
# takes the quadrant form of the flagship's stage 0 ([4, 8, 16, 32])
CONFS = {
    "padded": copy.deepcopy(TINY_MODEL_CONF),
    "quadrant": copy.deepcopy(TINY_MODEL_CONF),
}
CONFS["quadrant"]["model"]["cross_embed_kernel_sizes"] = [[4, 8, 16, 32], [2, 4], [2, 4], [2, 4]]
DATA = {"source": {"ERA5": {
    "levels": [0.0, 1.0],
    "variables": {"prognostic": {"vars_3D": ["U", "T"], "vars_2D": ["SP", "T2M"]},
                  "dynamic_forcing": {"vars_2D": ["TISR"]},
                  "diagnostic": {"vars_2D": ["PRECIP"]}}}}}


def _bf16(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def _numpy_variables(model, x, seed: int):
    """Variables of the JAX model's own tree, drawn with numpy: kernels
    he_uniform, biases and norm parameters randomised (so every bias path is
    exercised), spectral u/v random unit vectors, then converged. The tree's
    shapes come from eval_shape, which skips compiling the init (~30 s)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def draw(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            lim = np.sqrt(6.0 / np.prod(s.shape[:-1]))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "'u'" in name or "'v'" in name:
            v = rng.standard_normal(s.shape)
            return (v / np.linalg.norm(v)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return converge_spectral(jax.tree_util.tree_map_with_path(draw, shapes))


@pytest.fixture(scope="module", params=sorted(CONFS))
def built(request):
    """(conf, jax model, converged variables, numpy input) per embed form."""
    conf = CONFS[request.param]
    model = jax_load_model(conf)
    x = np.random.default_rng(0).standard_normal(
        (1, 1, 32, 64, model.base_input_channels)).astype(np.float32)
    return conf, model, _numpy_variables(model, x, 1), x


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_forward_matches_reference_f32(built):
    """f32: the same math in another summation order (1e-4 relative)."""
    conf, model, variables, x = built
    ref = jit_lowopt(model.apply)(variables, jnp.asarray(x))
    port = load_model(conf, device="cpu")
    port.load_state_dict(from_jax_variables(_to_numpy(variables), conf, device="cpu"))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert _rel(out.numpy(), ref) < 1e-4


def test_forward_matches_reference_bf16(built):
    """bf16 weights and compute on both sides, as the flagship runs. The
    routes round at different points: the port's fused FF keeps f32 between
    fc1 and GELU and adds b1 in f32, and its attention keeps f32 scores,
    where the reference rounds those to bf16 (window_attention.py:134-146).
    Through ~25 layers that stays within 5e-2 of max |out|."""
    conf, model, variables, x = built
    jconf = copy.deepcopy(conf)
    jconf["model"]["compute_dtype"] = "bfloat16"
    jconf["model"]["use_spectral_norm"] = False
    jmodel = jax_load_model(jconf)
    folded = _to_numpy(_bf16(fold_spectral(variables)["params"]))
    ref = jit_lowopt(jmodel.apply)({"params": _bf16(folded)}, jnp.asarray(x, jnp.bfloat16))
    port = load_model(jconf, device="cpu")
    port.load_state_dict(from_jax_variables({"params": folded}, jconf, device="cpu"))
    port = port.to(torch.bfloat16)
    with torch.no_grad():
        out = port(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert _rel(out.float().numpy(), jnp.asarray(ref, jnp.float32)) < 5e-2


def test_rollout_matches_reference(built):
    """Three steps against JAX make_scan_rollout: final state and per-step
    channel means, f32 (1e-4 relative)."""
    conf, model, variables, x = built
    full = {**conf, "data": DATA}
    jschema, schema = JSchema.from_config(full), ChannelSchema.from_config(full)
    jrun = jax_scan_rollout(model, jschema, 3)
    jx, jstats = jit_lowopt(jrun)(variables, jnp.asarray(x))
    port = load_model(conf, device="cpu")
    port.load_state_dict(from_jax_variables(_to_numpy(variables), conf, device="cpu"))
    tx, tstats = make_scan_rollout(port, schema, 3, device="cpu")(torch.from_numpy(x))
    assert tstats.shape == (3, model.base_output_channels)
    assert _rel(tx.numpy(), jx) < 1e-4
    assert _rel(tstats.numpy(), jstats) < 1e-4
    # the step-by-step engine agrees with the loop
    engine = RolloutEngine(port, schema, device="cpu")
    outs = engine.run(torch.from_numpy(x), 3)
    engine.close()
    assert len(outs) == 3
    np.testing.assert_allclose(outs[-1].mean(axis=(0, 1, 2, 3)), tstats[-1].numpy(),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- the bridge
def test_bridge_rejects_unknown_missing_and_stacked_keys(built):
    conf, _, variables, _ = built
    v = _to_numpy(variables)
    extra = copy.deepcopy(v)
    extra["params"]["cel0"]["bogus"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(KeyError, match="unknown"):
        from_jax_variables(extra, conf, device="cpu")
    missing = copy.deepcopy(v)
    del missing["params"]["up_block4"]
    with pytest.raises(KeyError, match="missing"):
        from_jax_variables(missing, conf, device="cpu")
    # credit_tpu's scan_blocks checkpoints stack each stage's blocks under
    # blocks/: params and spectral bridge to the same state, folded or not
    stacked = jax.tree_util.tree_map(np.asarray, {
        "params": stack_block_params(v["params"]),
        "spectral": stack_block_params(v["spectral"])})
    assert "blocks" in stacked["params"]["transformer0"]
    for fold in (True, False):
        want = from_jax_variables(v, conf, device="cpu", fold=fold)
        got = from_jax_variables(stacked, conf, device="cpu", fold=fold)
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_init_folded_gives_unit_spectral_norms_and_bounded_output():
    conf = CONFS["quadrant"]
    model = init_folded(conf, torch.Generator().manual_seed(0), device="cpu")
    # 30 power iterations from random vectors estimate sigma to within a
    # few 1e-3 on these matrices (as credit_tpu's converge_spectral does)
    for kern in (model.transformer1.short_ff0.fc1.kernel, model.up_block1.res_conv0.kernel,
                 model.cel0.conv3.kernel):
        w = kern.detach().double().reshape(-1, kern.shape[-1])
        assert abs(torch.linalg.matrix_norm(w, ord=2).item() - 1.0) < 2e-2
    x = torch.randn((1, 1, 32, 64, model.base_input_channels),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y = model(x)
    assert torch.isfinite(y).all() and y.abs().max() < 1e3


def test_load_model_routing_keys_and_unported_types():
    """The TPU routing keys are accepted and ignored; the U-Net, once
    refused, builds (every model type is ported: its parity is in
    tests/test_torch_port_models.py), and an unknown type raises."""
    conf = copy.deepcopy(CONFS["padded"])
    conf["model"].update(pallas_conv="force", ff_fusion="auto", use_pallas_attention=True,
                         scan_blocks=False, remat=False)
    assert load_model(conf, device="cpu") is not None
    unet = load_model({"model": {"type": "unet", "image_height": 8, "image_width": 16}},
                      device="cpu")
    assert type(unet).__name__ == "UNet" and unet.head.kernel.shape == (1, 1, 64, 64)
    with pytest.raises(KeyError, match="no-such-model"):
        load_model({"model": {"type": "no-such-model"}}, device="cpu")


# ------------------------------------------------------------- hygiene
def _port_files():
    for dirpath, _, names in os.walk(os.path.join(ROOT, "credit_torch")):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_files()), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    tree = ast.parse(open(path).read())
    banned = ("jax", "flax", "credit_tpu", "jaxlib", "optax", "bench", "__graft_entry__")
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in banned, f"{path} imports {name}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, credit_torch.rollout, credit_torch.models, credit_torch.convert_jax, "
            "credit_torch.models.fuxi, credit_torch.models.swin, "
            "credit_torch.trainers.trainer, credit_torch.losses, credit_torch.postblock, "
            "credit_torch.grid, credit_torch.physics.core, credit_torch.tools.bench_conv, "
            "credit_torch.tools.bench_conv_ffk, credit_torch.applications, credit_torch.config, "
            "credit_torch.metrics, credit_torch.data.local, credit_torch.data.era5, "
            "credit_torch.data.multi_source, credit_torch.data.prefetch, "
            "credit_torch.data.replay_buffer, credit_torch.data.sampler, "
            "credit_torch.trainers.preflight, credit_torch.utils.ncio, credit_torch.models.sdl, "
            "credit_torch.native.fastload, credit_torch.data.zarrlite, credit_torch.data.obs, "
            "credit_torch.data.projection, credit_torch.data.tisr, credit_torch.physics.solar, "
            "credit_torch.ops.regrid, credit_torch.ops.sht, credit_torch.preblock, "
            "credit_torch.physics.interp, credit_torch.physics.pole_filter, "
            "credit_torch.physics.advection, credit_torch.physics.skebs, "
            "credit_torch.physics.skebs_nets, credit_torch.postblock.stochastic, "
            "credit_torch.postblock.wind_filter, credit_torch.models.unet, credit_torch.models.graph, "
            "credit_torch.models.regional, credit_torch.models.wxformer_next, "
            "credit_torch.models.diffusion_heads, credit_torch.models.variants, "
            "credit_torch.models.debugger, credit_torch.diffusion, "
            "credit_torch.trainers.diffusion, credit_torch.ensemble.noise, "
            "credit_torch.ensemble.bred_vector, credit_torch.ensemble.sdl_wrapper, "
            "credit_torch.ptype, credit_torch.trainers.ic_optimization, "
            "credit_torch.applications.rollout_metrics, "
            "credit_torch.applications.ensemble_eval, credit_torch.utils.seed, "
            "credit_torch.parallel.distributed, credit_torch.parallel.mesh, "
            "credit_torch.parallel.validate, credit_torch.parallel.sharding, "
            "credit_torch.parallel.halo, credit_torch.parallel.ring_crps, "
            "credit_torch.applications.benchmark, credit_torch.manifests, "
            "credit_torch.convert_torch, credit_torch.nwp, credit_torch.serve, "
            "credit_torch.ocean, credit_torch.tuning, credit_torch.visualization, "
            "credit_torch.applications.realtime, credit_torch.cli, credit_torch.cli.main\n"
            # credit_torch.__main__ runs the CLI: with no subcommand it exits 2
            "try:\n    import credit_torch.__main__\nexcept SystemExit as e:\n"
            "    assert e.code == 2, e.code\n"
            "assert 'jax' not in sys.modules and 'credit_tpu' not in sys.modules, "
            "sorted(m for m in sys.modules if m.startswith(('jax', 'credit_tpu')))")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_entry_points_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    conf = CONFS["padded"]
    schema = ChannelSchema.from_config({**conf, "data": DATA})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_folded(conf, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train(conf, torch.Generator())
    model = load_model(conf, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_scan_rollout(model, schema, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RolloutEngine(model, schema)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(model, WeightedLoss(), make_optimizer({}, constant(1e-4)), schema)


def test_rollout_engine_refuses_unported_options(tmp_path):
    """The Normalizer (from netCDF statistics too), stateless postblocks and
    stateful ones (SKEBS) are ported: the engine sets a stateful block's
    state up for the first step's batch, hands it on from step to step with
    the engine's generator, and `reset` starts it again."""
    conf = CONFS["padded"]
    schema = ChannelSchema.from_config({**conf, "data": DATA})
    model = load_model(conf, device="cpu")

    class Stateful:
        is_stateful = True

        def init_state(self, batch_size, device="cpu"):
            return torch.zeros(batch_size, device=device)

        def __call__(self, y, x, state, generator):
            assert isinstance(generator, torch.Generator)
            return y + state[:, None, None, None, None], state + 1

    block = Stateful()
    engine = RolloutEngine(model, schema, postblocks=[block], device="cpu")
    x = torch.zeros(2, 1, 32, 64, schema.n_input)
    ys = [engine.step(x)[0] for _ in range(3)]
    assert torch.equal(engine._states[0], torch.full((2,), 3.0))
    for k, y in enumerate(ys[1:], 1):
        assert torch.equal(y - ys[0], torch.full_like(y, float(k)))
    engine.reset(2)
    assert torch.equal(engine.step(x)[0], ys[0])
    engine.close()
    paths = [str(tmp_path / "mean.nc"), str(tmp_path / "std.nc")]
    for path, (a, b) in zip(paths, [((0.0, 1.0), 5.0), ((2.0, 3.0), 7.0)]):
        Dataset({"U": (("level",), np.asarray(a, np.float32)),
                 "T": (("level",), np.asarray(a, np.float32) + 1), "SP": ((), np.float32(b)),
                 "T2M": ((), np.float32(b + 1)), "TISR": ((), np.float32(b + 2)),
                 "PRECIP": ((), np.float32(b + 3))}).to_netcdf(path)
    ours = Normalizer.from_netcdf(schema, *paths)
    ref = JNormalizer.from_netcdf(JSchema.from_config({**conf, "data": DATA}), *paths)
    for stat in ("input_mean", "input_std", "target_mean", "target_std"):
        assert np.array_equal(getattr(ours, stat).numpy(), np.asarray(getattr(ref, stat))), stat
    assert ours.input_std.numpy().tolist()[:2] == [2.0, 3.0]
    engine = RolloutEngine(model, schema, normalizer=Normalizer.identity(schema),
                           postblocks=[lambda y, x: y], device="cpu")
    engine.close()

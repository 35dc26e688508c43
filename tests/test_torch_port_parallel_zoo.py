"""NextGen WXFormer, the U-Net family, graph and debugger lat-sharded under
domain, on the CPU.

One launch of two spawned gloo ranks (`torch_port_parallel_worker.py`'s
`zoo` scenario, a FileStore under tmp_path) runs, at (dp, tp, domain) =
(1, 1, 2), each case of CASES: tiny models of credit_tpu's numpy weights,
the eval forward and one train step (MSE, AdamW with clip and decay) on
the mesh against the same ranks' unsharded forward and step, and against
credit_tpu's step on its own (1, 1, 2) mesh (its optax AdamW on its
gradient; its loss and gradient: the update is the port's AdamW, held to
the unsharded step's). The cases:

- `nextgen`: tests/test_torch_port_models.py's 32x64 NextGen (two frames):
  stage rows 16/8/4/2, so every stage and the bottleneck run on slabs;
- `nextgen_24`: 24 rows, stage rows 12/6/3/1: stage 2 onward is gathered
  and the up path cuts the field back to slabs at the stage-1 skip; its
  column attention pooled 2x2, the resize back on slabs;
- `unet` (30x60, padded to 32) and `unet_deep` (24x32, four levels: the
  deepest pools 3-row slabs, so it is gathered and the up path re-shards);
- `unet_downscaling` (16x30, resized to 30x60) and
  `unet-diffusion` (a plain forward: zero noise at time 0);
- `graph` (8x16 kNN graph) and `debugger`.

On the mesh kernel 2's and kernel 1's largest inputs have fewer rows than
unsharded; the gather paths taken are those GATHER_PATHS lists and no
other; NextGen's bottleneck pools on slabs (each rank's agg_w / scatter_w
gradient nonzero on its own nodes only, their sum the unsharded one). The
same launch runs `unet-diffusion`'s denoising step through
trainers/diffusion.py at domain 2 against the trainer without parallelism,
and a 3-step RolloutEngine of the folded 32x64 NextGen on the mesh against
unsharded.

In this process: every registered model type is lat-sharded, the
bottleneck's MLP keeps gradient divisor 1, and the validator keeps
credit_tpu's padded-height check (NextGen's unpadded 721 rows refused at
domain 2).
"""

import copy
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from credit_tpu.models import load_model as jax_load_model
from credit_tpu.parallel.mesh import build_mesh as jax_mesh
from tests.test_torch_port_model import _numpy_variables, _to_numpy
from tests.test_torch_port_models import MODELS as ZOO
from tests.test_torch_port_parallel_fit import _flat, _grad_close, _mine, _update_close
from tests.test_torch_port_parallel_fuxi import DATA, TRAINER
from torch_port_fixtures import jit_lowopt, start_ranks, two_torch_threads  # noqa: F401

MESH = (1, 1, 2)
NG = ZOO["nextgen_wxformer"][0]
UN = ZOO["unet"][0]
# NextGen's data section for its rollout: 4 3-D variables at 3 levels and a
# surface one (13 prognostic), a forcing and a diagnostic: 14 in, 14 out
DATA_NG = {"source": {"ERA5": {"levels": [0.0, 1.0, 2.0], "variables": {
    "prognostic": {"vars_3D": ["U", "V", "T", "Q"], "vars_2D": ["SP"]},
    "dynamic_forcing": {"vars_2D": ["TISR"]}, "diagnostic": {"vars_2D": ["PRECIP"]}}}},
    "forecast_len": 1, "history_len": 2}
# name -> (model section, input of one sample, output of one sample)
MODELS = {
    "nextgen": (NG, (2, 32, 64, 14), (1, 32, 64, 14)),
    # local windows of 1 where the stage's 3 and 1 rows are; without
    # spectral norm (which `nextgen` holds), whose power iterations cost
    # credit_tpu's reference a third of its compile
    "nextgen_24": ({**NG, "image_height": 24, "local_window_size": [2, 2, 1, 1],
                    "global_window_size": [2, 2, 1, 1], "col_attn_stride": 2,
                    "use_spectral_norm": False},
                   (2, 24, 64, 14), (1, 24, 64, 14)),
    "unet": (UN, (1, 30, 60, 6), (1, 30, 60, 6)),
    # level rows 24/12/6/3: the deepest level's pools straddle the slabs
    "unet_deep": ({**UN, "image_height": 24, "image_width": 32, "encoder_dims": [8, 16, 16, 32]},
                  (1, 24, 32, 6), (1, 24, 32, 6)),
    "unet_downscaling": (ZOO["unet_downscaling"][0], (2, 16, 30, 6), (1, 30, 60, 6)),
    "unet-diffusion": (ZOO["unet-diffusion"][0], (1, 30, 60, 6), (1, 30, 60, 6)),
    "graph": ({**ZOO["graph"][0], "output_frames": 1}, (1, 8, 16, 5), (1, 8, 16, 5)),
    "debugger": (ZOO["debugger"][0], (2, 8, 16, 6), (1, 8, 16, 5)),
}
CASES = list(MODELS)
# the gather paths a rank takes in one forward on the mesh, by site. Each
# window of a long attention spans every slab (the CrossFormer family's
# "long_attn" path, once a stage on slabs); a local window of 2 does not
# divide a 1-row (32x64: stage 3) or 3-row (24 rows: stage 1) slab
# ("short_attn"); "stage": NextGen's stage 2 of 24 rows, 3 in all;
# "level": the deep U-Net's fourth level. Nothing else: the convs, the
# resizes, the column attention's pools and the bottleneck stay on slabs
GATHER_PATHS = {"nextgen": {"long_attn": 4, "short_attn": 1},
                "nextgen_24": {"long_attn": 2, "short_attn": 1, "stage": 1},
                "unet_deep": {"level": 1}}
NEXTGEN = [c for c in CASES if c.startswith("nextgen")]
# the models that launch kernel 2 (and kernel 1: NextGen)
CONV = NEXTGEN + [c for c in CASES if c.startswith("unet")]


def _step_grad_close(got: dict, want: dict, tol: float):
    """`_grad_close`, where a tensor whose largest gradient is below 1e-2
    of the model's is held to tol of the model's largest: a conv bias
    before GroupNorm (the U-Nets have 4 to 8 of them) has a true gradient
    of 0, and its f32 gradient is rounding noise of ~1e-7 of the model's
    largest (the unsharded U-Net's dec0.conv1.bias reads 7e-6 of
    `_grad_close`'s 1e-2 floor against the same port in f64, and the
    mesh step's noise adds to it)."""
    gmax = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        scale = np.abs(w).max() if np.abs(w).max() >= 1e-2 * gmax else gmax
        assert np.abs(got[k] - w).max() <= tol * scale, k
    num = np.sqrt(sum(((got[k] - w) ** 2).sum() for k, w in want.items()))
    den = np.sqrt(sum((w ** 2).sum() for w in want.values()))
    assert num <= tol * den


def _conf(name: str, data=DATA) -> dict:
    return {"model": copy.deepcopy(MODELS[name][0]), "data": data, "trainer": dict(TRAINER)}


def _reference(jm, variables, x, y):
    """credit_tpu's loss and gradient on its own MESH, x sharded as its
    batch_spec (compiled at XLA's lowest optimisation level)."""
    mesh = jax_mesh(*MESH, jax.devices()[:int(np.prod(MESH))])

    def loss(params, xs):
        pred, _ = jm.apply({**variables, "params": params}, xs, train=True,
                           mutable=["spectral"])
        return jnp.mean((pred - y) ** 2)

    xs = jax.device_put(x, NamedSharding(mesh, P("dp", None, "domain", None, None)))
    val, grads = jit_lowopt(jax.value_and_grad(loss))(variables["params"], xs)
    return {"loss": float(val), "grads": _flat(_to_numpy(grads))}


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """The launch (every case, the diffusion trainer's step, the NextGen
    rollout), and credit_tpu's mesh steps computed here while it runs."""
    root = tmp_path_factory.mktemp("zoo")
    cases, inputs = [], {}
    for i, name in enumerate(CASES):
        conf = _conf(name)
        jm = jax_load_model(conf)
        _, xshape, yshape = MODELS[name]
        rng = np.random.default_rng(60 + i)
        x = rng.standard_normal((1, *xshape)).astype(np.float32)
        y = rng.standard_normal((1, *yshape)).astype(np.float32)
        variables = _to_numpy(_numpy_variables(jm, x, 3))
        with open(root / f"{name}.pkl", "wb") as f:
            pickle.dump(variables, f)
        np.savez(root / f"{name}.npz", x=x, y=y)
        cases.append({"tag": name, "conf": conf, "variables": str(root / f"{name}.pkl"),
                      "batch": str(root / f"{name}.npz"), "mesh": list(MESH)})
        inputs[name] = (jm, variables, x, y)
    diffusion = {**_conf("unet-diffusion"), "diffusion": {"timesteps": 10}}
    diffusion["trainer"].update(type="era5-diffusion", parallelism={"domain": 2})
    rollout = {**cases[0], "conf": _conf("nextgen", DATA_NG)}
    wait = start_ranks("zoo", 2, root, {"cases": cases, "rollout": rollout, "trainer_step": {
        "conf": diffusion, "batch": cases[CASES.index("unet-diffusion")]["batch"]}},
        timeout=200.0)
    refs = {name: {**_reference(*args), "start": _flat(args[1]["params"])}
            for name, args in inputs.items()}
    return wait(), refs


@pytest.mark.parametrize("tag", CASES)
def test_zoo_mesh_forward_matches_unsharded(zoo, tag):
    """The eval forward at domain 2, whole on every rank, within 1e-5 of
    its largest value of the unsharded one; kernel 2's and kernel 1's
    largest inputs have fewer rows than unsharded (the models that launch
    them); the gather paths taken are GATHER_PATHS' and no other, in the
    forward and in the train step."""
    ranks, _ = zoo
    want_sites = sorted(f"{k}:{v}" for k, v in GATHER_PATHS.get(tag, {}).items())
    for r in ranks:
        want = r[f"{tag}_pred_one"]
        np.testing.assert_allclose(r[f"{tag}_pred_mesh"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        conv, ff, _ = r[f"{tag}_rows_mesh"]
        conv1, ff1, full1 = r[f"{tag}_rows_one"]
        assert full1 == 0
        if tag in CONV:
            assert conv < conv1, (conv, conv1)
        if tag in NEXTGEN:
            assert ff < ff1, (ff, ff1)
        assert list(r[f"{tag}_gathers_fwd"]) == want_sites
        assert list(r[f"{tag}_gathers_step"]) == want_sites


@pytest.mark.parametrize("tag", CASES)
def test_zoo_mesh_step_matches_unsharded_and_reference(zoo, tag):
    """On both ranks: against the unsharded step the loss within 1e-6, the
    gradient within 1e-5 (`_step_grad_close`), the update as `_update_close`;
    against credit_tpu's step on its own (1, 1, 2) mesh the loss within
    1e-5 and the gradient within 1e-4 (the limits
    test_torch_port_parallel_fit.py holds its reference mesh steps to)."""
    ranks, refs = zoo
    ref, start = refs[tag], refs[tag]["start"]
    for rank in ranks:
        mesh, one = f"mesh_{tag}", f"one_{tag}"
        np.testing.assert_allclose(rank[f"{mesh}_loss"], rank[f"{one}_loss"], rtol=1e-6)
        one_g = _mine(rank, one, "grad")
        _step_grad_close(_mine(rank, mesh, "grad"), one_g, 1e-5)
        _update_close(_mine(rank, mesh, "param"), _mine(rank, one, "param"), start, one_g)
        np.testing.assert_allclose(rank[f"{mesh}_loss"], ref["loss"], rtol=1e-5)
        _grad_close(_mine(rank, mesh, "grad"), ref["grads"], 1e-4)


@pytest.mark.parametrize("tag", NEXTGEN)
def test_nextgen_bottleneck_sums_its_nodes_over_the_ranks(zoo, tag):
    """Where stage 3 is on slabs, each rank's own gradient of agg_w
    (columns) and scatter_w (rows) is nonzero on its nodes only, the
    ranks' sum within 1e-5 of its largest of the unsharded gradient, and
    the pooled nodes were summed by one all-reduce in the mesh step's
    forward; where stage 3 is gathered (24 rows) every rank holds a share
    of the whole gradient and nothing is summed in the bottleneck."""
    ranks, _ = zoo
    on_slabs = tag != "nextgen_24"
    assert [int(r[f"{tag}_slab_sums"]) for r in ranks] == [int(on_slabs)] * 2
    for name, axis in (("agg_w", 1), ("scatter_w", 0)):
        one = ranks[0][f"{tag}_raw_{name}_one"]
        mesh = [r[f"{tag}_raw_{name}_mesh"] for r in ranks]
        np.testing.assert_array_equal(ranks[1][f"{tag}_raw_{name}_one"], one)
        np.testing.assert_allclose(mesh[0] + mesh[1], one, rtol=0,
                                   atol=1e-5 * np.abs(one).max())
        if on_slabs:
            half = one.shape[axis] // 2
            for r, g in enumerate(mesh):
                own = np.moveaxis(g, axis, 0)
                assert np.abs(own[r * half:(r + 1) * half]).min() > 0, (name, r)
                assert not np.any(own[(1 - r) * half:(2 - r) * half]), (name, r)


def test_graph_rank_owns_its_slab_edges(zoo):
    """Each rank runs the edges into its 4 rows (half the edge list here)
    over a halo of the edge list's largest row distance."""
    ranks, _ = zoo
    mine, total, halo = ranks[0]["graph_edges"]
    assert [int(r["graph_edges"][0]) for r in ranks] == [total // 2] * 2
    assert 1 <= halo <= 4


def test_unet_diffusion_denoising_step_domain2(zoo):
    """The era5-diffusion trainer's step of the U-Net denoiser at domain 2
    (lat-sharded under its time FiLM) on both ranks against the same
    trainer without parallelism: the loss within 1e-6, the gradient within
    1e-5 (`_step_grad_close`)."""
    ranks, _ = zoo
    for rank in ranks:
        np.testing.assert_allclose(rank["ts_mesh_loss"], rank["ts_one_loss"], rtol=1e-6)
        one, mesh = _mine(rank, "ts_one", "grad"), _mine(rank, "ts_mesh", "grad")
        assert one.keys() == mesh.keys() and any(k.startswith("time_film") for k in one)
        _step_grad_close(mesh, one, 1e-5)


def test_nextgen_rollout_engine_on_the_mesh(zoo):
    """RolloutEngine.run of the folded 32x64 NextGen, 3 steps at domain 2,
    every rank's predictions within 1e-5 of their largest of the unsharded
    engine's."""
    ranks, _ = zoo
    for r in ranks:
        want = r["rollout_one"]
        assert want.shape[0] == 3
        np.testing.assert_allclose(r["rollout_mesh"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------- in-process
def test_every_registered_model_is_lat_sharded():
    """All 17 model types credit_tpu registers are lat-sharded in the port
    (the trainer's "not lat-sharded" warning is left for a type registered
    later without a slab forward)."""
    from credit_torch import registry
    from credit_torch.models import PORTED, load_model

    load_model({"model": copy.deepcopy(MODELS["debugger"][0])}, device="cpu")  # registers all
    assert len(set(PORTED)) == 17
    for name in PORTED:
        assert getattr(registry.get("model", name), "lat_sharded", False) is True, name


def test_bottleneck_mlp_keeps_divisor_1_and_validator_refuses_721_rows():
    """At domain 2 a lat-sharded NextGen's gradient divisors are 1 for
    every parameter, the bottleneck's channel MLP included (each rank's
    gradient of it comes from its own nodes' scatter: a share); the
    validator refuses NextGen's unpadded 721 rows at domain 2, as
    credit_tpu's does, and takes 720."""
    from credit_torch.models import load_model
    from credit_torch.parallel.sharding import gradient_divisors
    from credit_torch.parallel.validate import validate_sharding

    class Mesh:
        shape = {"dp": 1, "tp": 1, "domain": 2}

    model = load_model({"model": copy.deepcopy(NG)}, device="cpu")
    names = [k for k, _ in model.named_parameters()]
    mlp = [k for k in names if "spectral_bottleneck.mlp_" in k]
    assert len(mlp) == 4
    assert gradient_divisors(names, Mesh, model.lat_sharded) == [1.0] * len(names)
    for h, bad in ((721, True), (720, False)):
        conf = {"model": {**NG, "image_height": h}}
        problems = validate_sharding(conf, mesh=Mesh, model=model)
        assert bool(problems) == bad and all("image_height=721" in p for p in problems)

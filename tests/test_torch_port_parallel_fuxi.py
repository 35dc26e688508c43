"""The SwinV2 family lat-sharded under domain, and ZeRO-3 over dp, on the CPU.

Two spawned gloo ranks (`torch_port_parallel_worker.py`, one launch, a
FileStore under tmp_path) run:

- `swin_family`: tiny `fuxi`, `swin`, `wrf` and `dscale` models of
  credit_tpu's numpy weights at (dp, tp, domain) = (1, 1, 2), and a tiny
  FuXi at (2, 1, 1): the eval forward and one train step (MSE, AdamW with
  clip and decay) on the mesh against the same ranks' unsharded forward
  and step, and against credit_tpu's step on its own mesh of the same
  shape (its optax AdamW on its gradient). Each tiny FuXi's stage has an
  odd number of window rows (3: the slabs hold 2 and 1), and its shifted
  windows straddle the slab boundary; `fuxi_pad`'s stage zero-pads its 6
  rows to 8 (the first and last rank each hold pad), held against the
  unsharded port only (credit_tpu's gradient there is NaN, ROADMAP
  queue 3). On the slabs kernel 2's and kernel 1's largest inputs have
  fewer rows than unsharded, and no gather path is taken;
- `swin_family` at tensor 2 (1, 2, 1) for tiny `fuxi`, `swin`,
  `crossformer-ensemble` (credit_tpu's noise replayed in every port
  forward) and `nextgen_wxformer`: each FF call on half its hidden width,
  the step against the unsharded port and credit_tpu's step on its own
  (1, 2, 1) mesh;
- `zero3_frees`: a ZeRO-3 model let go frees its parameters at once;
- `zero3`: ZeRO-3 through the Trainer at data 2 for a tiny CrossFormer and
  a tiny FuXi (with `sn_external`: its power iterations on each block's
  gathered kernels): the resident parameter and gradient elements between steps
  (each rank's chunks plus the whole small tensors, exactly), the step
  against the unsharded one, and a checkpoint written at dp 2 resumed at
  world size 1 against two uninterrupted unsharded steps.

In this process: the four models are lat-sharded and the validator raises
one ValueError naming the model where its rows do not split.
"""

import copy
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from __graft_entry__ import TINY_MODEL_CONF
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.parallel.mesh import build_mesh as jax_mesh
from credit_tpu.trainers import trainer as jtrainer
from credit_tpu.trainers.scheduler import load_scheduler as jax_scheduler
from tests.test_torch_port_ensemble import _noise_drawer
from tests.test_torch_port_ensemble import _numpy_variables as ens_variables
from tests.test_torch_port_model import _numpy_variables, _to_numpy
from tests.test_torch_port_parallel_fit import _flat, _grad_close, _mine, _update_close
from torch_port_fixtures import jit_lowopt, start_many, two_torch_threads  # noqa: F401

LR = 1e-3
TRAINER = {"learning_rate": LR, "weight_decay": 0.01, "grad_max_norm": 1.0}
DATA = {"source": {"ERA5": {"levels": [0.0, 1.0], "variables": {
    "prognostic": {"vars_3D": ["U", "T"], "vars_2D": ["SP", "T2M"]},
    "dynamic_forcing": {"vars_2D": ["TISR"]}, "diagnostic": {"vars_2D": ["PRECIP"]}}}},
    "forecast_len": 1, "history_len": 1}
# 40x32 earth-padded to 48x32, 2x4x4 cubes: 12x8 embedded rows, 6x4 after
# the DownBlock, windows of 2: 3 window rows over 2 ranks (2 and 1)
FUXI = {"type": "fuxi", "image_height": 40, "image_width": 32, "patch_height": 4,
        "patch_width": 4, "levels": 2, "frames": 2, "frame_patch_size": 2, "dim": 32,
        "num_groups": 8, "channels": 2, "surface_channels": 2, "input_only_channels": 1,
        "output_only_channels": 1, "num_heads": 4, "depth": 2, "window_size": 2,
        "use_spectral_norm": True, "interp": True,
        "padding_conf": {"activate": True, "mode": "earth", "pad_lat": [4, 4],
                         "pad_lon": [0, 0]}}
MODELS = {
    "fuxi": FUXI,
    # windows of 4: the stage pads 6x4 to 8x4 (1 row a side), one window row a rank
    "fuxi_pad": {**FUXI, "window_size": 4},
    # 30x30 in 2x2 patches: 15x15, windows of 5, 3 window rows
    "swin": {"type": "swin", "image_height": 30, "image_width": 30, "patch_height": 2,
             "patch_width": 2, "levels": 2, "frames": 1, "channels": 2, "surface_channels": 2,
             "embed_dim": 32, "depth": 2, "num_heads": 4, "window_size": 5},
    # 24x32 in 2x2 cubes: 12x16, 6x8 after the DownBlock, windows of 2
    "wrf": {"type": "wrf", "param_interior": dict(
        image_height=24, image_width=32, patch_height=2, patch_width=2, levels=2, frames=1,
        frame_patch_size=1, channels=2, surface_channels=1, input_only_channels=1,
        output_only_channels=0, dim=32), "depth": 2, "num_heads": 4, "window_size": 2,
        "num_groups": 8},
    "dscale": {"type": "dscale", "image_height": 24, "image_width": 32, "out_image_height": 48,
               "out_image_width": 64, "patch_height": 2, "patch_width": 2,
               "total_input_channels": 7, "total_target_channels": 11, "time_encode_dim": 0,
               "frames": 1, "frame_patch_size": 1, "dim": 32, "depth": 2, "num_heads": 4,
               "window_size": 2, "num_groups": 8},
    # dim 64: the SwinV2 MLPs, the DownBlock's and UpBlock's convs reach
    # 2^14 elements and are held as dp chunks
    "fuxi_wide": {**FUXI, "dim": 64},
    # the CrossFormer family's FF under tp: TINY_MODEL_CONF's noisy model
    # (2/4/8/16 heads of 8) and NextGen at DATA's channels
    "ensemble": {**TINY_MODEL_CONF["model"], "type": "crossformer-ensemble", "dim_head": 8},
    "nextgen": {"type": "nextgen_wxformer", **{k: v for k, v in TINY_MODEL_CONF["model"].items()
                                               if k not in ("type", "interp", "padding_conf")},
                "dim_head": 8, "col_attn_heads": 2, "num_spectral_nodes": 4},
}
# (case, model, mesh); the batch holds one sample a dp row. At tensor 2 each
# rank's FF runs on its half of the hidden layer
CASES = [("fuxi", "fuxi", (1, 1, 2)), ("fuxi_pad", "fuxi_pad", (1, 1, 2)),
         ("swin", "swin", (1, 1, 2)), ("wrf", "wrf", (1, 1, 2)), ("dscale", "dscale", (1, 1, 2)),
         ("fuxi_dp2", "fuxi_wide", (2, 1, 1)), ("fuxi_tp2", "fuxi", (1, 2, 1)),
         ("swin_tp2", "swin", (1, 2, 1)), ("ensemble_tp2", "ensemble", (1, 2, 1)),
         ("nextgen_tp2", "nextgen", (1, 2, 1))]
TP_CASES = [c[0] for c in CASES if c[2][1] > 1]
# credit_tpu's gradient is NaN where the SwinV2 stage zero-pads
NO_REFERENCE = ("fuxi_pad",)


def _conf(name: str) -> dict:
    return {"model": copy.deepcopy(MODELS[name]), "data": DATA, "trainer": dict(TRAINER)}


def _shapes(model: dict):
    """(input shape of one sample, output shape) of a tiny model."""
    if model["type"] == "wrf":
        pi = model["param_interior"]
        return (1, pi["image_height"], pi["image_width"], 6), (1, pi["image_height"],
                                                              pi["image_width"], 5)
    if model["type"] == "dscale":
        return ((1, model["image_height"], model["image_width"], 7),
                (1, model["out_image_height"], model["out_image_width"], 11))
    if model["type"] != "fuxi" and model["type"] != "swin":  # the CrossFormer family
        return (1, model["image_height"], model["image_width"], 7), (
            1, model["image_height"], model["image_width"], 7)
    fr = model["frames"]
    out_c = 7 if model["type"] == "fuxi" else 6
    in_c = 7 if model["type"] == "fuxi" else 6
    return ((fr, model["image_height"], model["image_width"], in_c),
            (1, model["image_height"], model["image_width"], out_c))


def _reference(conf, variables, x, y, dims, rngs=None):
    """credit_tpu's step on its own (dp, tp, domain) mesh, x sharded as its
    batch_spec (compiled at XLA's lowest optimisation level): loss,
    gradients, AdamW-updated parameters. `rngs`: a noisy model's keys."""
    jm = jax_load_model(conf)
    mesh = jax_mesh(*dims, jax.devices()[:int(np.prod(dims))])

    def loss(params, xs):
        pred, _ = jm.apply({**variables, "params": params}, xs, train=True, rngs=rngs,
                           mutable=["spectral"])
        return jnp.mean((pred - y) ** 2)

    xs = jax.device_put(x, NamedSharding(mesh, P("dp", None, "domain", None, None)))
    val, grads = jit_lowopt(jax.value_and_grad(loss))(variables["params"], xs)
    opt = jtrainer.make_optimizer(conf, jax_scheduler(conf))
    new = jit_lowopt(lambda g, p: jax.tree_util.tree_map(
        lambda a, u: a + u, p, opt.update(g, opt.init(p), p)[0]))(grads, variables["params"])
    return {"loss": float(val), "grads": _flat(_to_numpy(grads)), "params": _flat(_to_numpy(new))}


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """Both scenarios in one launch of 2 ranks (`swin_family`'s cases, then
    `zero3`'s), credit_tpu's steps computed here while it runs."""
    root = tmp_path_factory.mktemp("swin_family")
    cases, refs, inputs = [], {}, []
    for i, (tag, name, dims) in enumerate(CASES):
        conf = _conf(name)
        jm = jax_load_model(conf)
        xshape, yshape = _shapes(conf["model"])
        rng = np.random.default_rng(40 + i)
        b = dims[0]
        x = rng.standard_normal((b, *xshape)).astype(np.float32)
        y = rng.standard_normal((b, *yshape)).astype(np.float32)
        rngs, noise = None, None
        if name == "ensemble":  # credit_tpu's draws, replayed in every port forward
            variables = ens_variables(jm, x, 3)
            rngs = {"noise": jax.random.PRNGKey(11)}
            noise = str(root / f"{tag}_noise.npz")
            np.savez(noise, **{k: v.numpy() for k, v in _noise_drawer(jm, variables)(
                rngs["noise"], x.shape).items()})
        else:
            variables = _to_numpy(_numpy_variables(jm, x, 3))
        with open(root / f"{tag}.pkl", "wb") as f:
            pickle.dump(variables, f)
        np.savez(root / f"{tag}.npz", x=x, y=y)
        cases.append({"tag": tag, "conf": conf, "variables": str(root / f"{tag}.pkl"),
                      "batch": str(root / f"{tag}.npz"), "mesh": list(dims), "noise": noise})
        if tag not in NO_REFERENCE:
            inputs.append((tag, conf, variables, x, y, dims, rngs))
    zcases = _zero3_cases(root)
    wait = start_many(2, root, [
        ("swin_family", {"cases": cases}), ("zero3", {"cases": zcases}),
        ("zero3_frees", {"conf": zcases[0]["conf"], "batch": zcases[0]["batch"]})],
        timeout=240.0)
    for tag, conf, variables, *args in inputs:
        refs[tag] = {**_reference(conf, variables, *args), "start": _flat(variables["params"])}
    family, zero3, frees = wait()
    return (family, refs), (zero3, frees)


@pytest.fixture(scope="module")
def family(launch):
    return launch[0]


@pytest.fixture(scope="module")
def zero3(launch):
    return launch[1][0]


def test_zero3_model_is_freed_with_its_last_reference(launch):
    """A ZeRO-3 model at data 2, its optimizer, step and state let go after
    a step: with Python's cyclic collector off, none of the bytes the rank
    held as parameters stays alive (nothing of ParamShards holds the
    model's blocks in a reference cycle, which only that collector would
    free: PERF.md, PR 19)."""
    for rank in launch[1][1]:
        assert int(rank["zero3_held_bytes"]) > 0
        assert int(rank["zero3_alive_bytes"]) == 0


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_mesh_forward_matches_unsharded(family, tag):
    """The eval forward on the mesh, whole on every rank (its dp row's
    sample), within 1e-5 of its largest value of the unsharded one; under
    domain 2 kernel 2's and kernel 1's largest inputs have fewer rows than
    unsharded, and no gather path (`context.on_full`) is taken."""
    ranks, _ = family
    dims = dict((c[0], c[2]) for c in CASES)[tag]
    for i, r in enumerate(ranks):
        want = np.split(r[f"{tag}_pred_one"], dims[0])[i // (dims[1] * dims[2])]
        np.testing.assert_allclose(r[f"{tag}_pred_mesh"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        conv, ff, full = r[f"{tag}_rows_mesh"]
        conv1, ff1, full1 = r[f"{tag}_rows_one"]
        assert full == full1 == 0
        if dims[2] > 1:
            assert ff < ff1 and (conv < conv1 or tag == "swin"), (conv, conv1, ff, ff1)


@pytest.mark.parametrize("tag", TP_CASES)
def test_tp_ff_runs_on_the_rank_slice(family, tag):
    """At tensor 2 every FF call of the step, forward and backward, runs on
    half the hidden width it runs at unsharded, on each rank (the widths
    kernel 1's and kernel 4's wrappers were given)."""
    ranks, _ = family
    for rank in ranks:
        one, mesh = rank[f"one_{tag}_ff_hidden"], rank[f"mesh_{tag}_ff_hidden"]
        assert len(one) > 2 and len(mesh) == len(one)
        np.testing.assert_array_equal(mesh, np.where(one > 0, one // 2, one))


@pytest.mark.parametrize("tag", [c[0] for c in CASES if c[0] not in TP_CASES])
def test_mesh_step_matches_unsharded_and_reference(family, tag):
    """On every rank: the loss within 1e-6 of the unsharded step's, the
    gradient within 1e-5 (`_grad_close`), the update as `_update_close`;
    against credit_tpu's mesh step the same limits. At dp 2 the rank holds
    its chunks and the whole small tensors, exactly, and no gradient is
    left on the parameters."""
    ranks, refs = family
    for rank in ranks:
        mesh, one = f"mesh_{tag}", f"one_{tag}"
        np.testing.assert_allclose(rank[f"{mesh}_loss"], rank[f"{one}_loss"], rtol=1e-6)
        one_g = _mine(rank, one, "grad")
        _grad_close(_mine(rank, mesh, "grad"), one_g, 1e-5)
        start = refs[tag]["start"] if tag in refs else None
        if start is not None:
            _update_close(_mine(rank, mesh, "param"), _mine(rank, one, "param"), start, one_g)
            np.testing.assert_allclose(rank[f"{mesh}_loss"], refs[tag]["loss"], rtol=1e-6)
            _grad_close(_mine(rank, mesh, "grad"), refs[tag]["grads"], 1e-5)
            _update_close(_mine(rank, mesh, "param"), refs[tag]["params"], start,
                          refs[tag]["grads"])
        if f"{mesh}_expected_resident" in rank:
            params, grads, left = rank[f"{mesh}_resident"]
            want = int(rank[f"{mesh}_expected_resident"])
            assert params == grads == want and left == 0
            assert want < int(rank[f"{one}_resident"][0])


@pytest.mark.parametrize("tag", TP_CASES)
def test_tp_mesh_step_matches_unsharded_and_reference(family, tag):
    """At tensor 2, on both ranks: against the unsharded step the loss
    within 1e-6, the gradient within 1e-5, the update as `_update_close`;
    against credit_tpu's step on its own (1, 2, 1) mesh, whose GSPMD sums
    the FF's and the attention's partial products in its own order, the
    limits test_torch_port_parallel_fit.py holds its reference mesh step
    to: the loss within 1e-5, the gradient within 1e-4, the update as
    `_update_close`."""
    ranks, refs = family
    start = refs[tag]["start"]
    for rank in ranks:
        mesh, one = f"mesh_{tag}", f"one_{tag}"
        np.testing.assert_allclose(rank[f"{mesh}_loss"], rank[f"{one}_loss"], rtol=1e-6)
        one_g = _mine(rank, one, "grad")
        _grad_close(_mine(rank, mesh, "grad"), one_g, 1e-5)
        _update_close(_mine(rank, mesh, "param"), _mine(rank, one, "param"), start, one_g)
        np.testing.assert_allclose(rank[f"{mesh}_loss"], refs[tag]["loss"], rtol=1e-5)
        _grad_close(_mine(rank, mesh, "grad"), refs[tag]["grads"], 1e-4)
        _update_close(_mine(rank, mesh, "param"), refs[tag]["params"], start, refs[tag]["grads"])


# --------------------------------------------------------------- ZeRO-3
def _zero3_conf(name: str) -> dict:
    if name == "crossformer":
        conf = copy.deepcopy(TINY_MODEL_CONF)
        conf["model"].update(dim_head=8)
    else:  # with spectral norm's power iterations outside the step
        conf = {"model": copy.deepcopy(MODELS["fuxi_wide"])}
    return {**conf, "data": DATA,
            "trainer": {**TRAINER, "use_ema": True, "train_batch_size": 2,
                        "sn_external": name == "fuxi", "parallelism": {"data": 2}}}


def _zero3_cases(root):
    cases = []
    for i, name in enumerate(("crossformer", "fuxi")):
        conf = _zero3_conf(name)
        xshape, yshape = _shapes(conf["model"]) if name == "fuxi" else (
            (1, 32, 64, 7), (1, 32, 64, 7))
        rng = np.random.default_rng(50 + i)
        path = root / f"zero3_{name}.npz"
        np.savez(path, x=rng.standard_normal((2, *xshape)).astype(np.float32),
                 y=rng.standard_normal((2, *yshape)).astype(np.float32))
        cases.append({"tag": name, "conf": conf, "batch": str(path), "root": str(root / "zero3")})
    return cases


@pytest.mark.parametrize("tag", ["crossformer", "fuxi"])
def test_zero3_holds_chunks_and_matches_unsharded(zero3, tag):
    """Between the steps each rank holds exactly its chunks plus the whole
    small tensors (fewer elements than the model's) as parameters, and as
    the gradients the optimizer is given, and leaves no gradient on the
    parameters; a seeded init of the held model gives its held kernels
    bitwise as one of a whole model; the first step's gradient within 1e-5 (`_grad_close`) and
    both losses within 1e-6 of the unsharded steps on the whole batch."""
    for rank in zero3:
        params, grads, left = rank[f"mesh_{tag}_resident"]
        want = int(rank[f"mesh_{tag}_expected_resident"])
        assert params == grads == want and left == 0
        assert want < int(rank[f"{tag}_whole_elements"])
        assert float(rank[f"mesh_{tag}_reseed_err"]) == 0.0  # seeded whole, then chunked
    r0 = zero3[0]
    np.testing.assert_allclose(r0[f"mesh_{tag}_loss"], r0[f"one_{tag}_loss"], rtol=1e-6)
    _grad_close(_mine(r0, f"mesh_{tag}", "grad"), _mine(r0, f"one_{tag}", "grad"), 1e-5)
    np.testing.assert_array_equal(zero3[1][f"mesh_{tag}_loss"], r0[f"mesh_{tag}_loss"])


@pytest.mark.parametrize("tag", ["crossformer", "fuxi"])
def test_zero3_checkpoint_resumes_at_world_size_1(zero3, tag):
    """The dp-2 checkpoint after one step, resumed in a trainer of one
    process for the second step: its loss within 1e-6 of the second of two
    uninterrupted unsharded steps, and its parameters, as the mesh's own
    after two steps, within 1e-5 of their norm of the uninterrupted ones
    and each element within 2 lr a step (Adam moves an element by at most
    lr a step; where a gradient is rounding noise its sign can differ), as
    test_torch_port_parallel_fit.py's checkpoint test holds them."""
    r0 = zero3[0]
    one = _mine(r0, f"one_{tag}", "param")
    np.testing.assert_allclose(r0[f"resumed_{tag}_loss"], r0[f"one_{tag}_loss"][1], rtol=1e-6)
    den = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in one.values()))
    for side in ("resumed", "mesh"):
        got = _mine(r0, f"{side}_{tag}", "param")
        assert got.keys() == one.keys()
        num = np.sqrt(sum(((got[k] - v).astype(np.float64) ** 2).sum() for k, v in one.items()))
        assert num <= 1e-5 * den, side
        for k, v in one.items():
            assert np.abs(got[k] - v).max() <= 2 * LR * 2, (side, k)


# --------------------------------------------------------------- in-process
def test_swin_family_is_lat_sharded_and_validated():
    """fuxi, swin, wrf and dscale are lat-sharded, as are the debugger and
    the U-Net since NextGen, the U-Net family, graph and debugger became
    so (tests/test_torch_port_parallel_zoo.py); a mesh whose domain ranks
    the rows cannot split over raises one ValueError naming the model."""
    from credit_torch.models import load_model
    from credit_torch.parallel.validate import assert_valid_sharding, validate_sharding

    class Mesh:
        def __init__(self, dom):
            self.shape = {"dp": 1, "tp": 1, "domain": dom}

    for name in ("fuxi", "swin", "wrf", "dscale"):
        model = load_model(_conf(name), device="cpu")
        assert model.lat_sharded is True, name
        assert validate_sharding(_conf(name), mesh=Mesh(2), model=model) == [], name
    others = {"debugger": {"type": "debugger", "frames": 1, "image_height": 8, "image_width": 16,
                           "levels": 2, "channels": 2, "surface_channels": 1},
              "unet": {"type": "unet", "frames": 1, "image_height": 30, "image_width": 60,
                       "levels": 2, "channels": 2, "surface_channels": 1,
                       "encoder_dims": [8, 16, 32]}}
    for name, m in others.items():
        assert load_model({"model": m}, device="cpu").lat_sharded is True, name
    model = load_model(_conf("fuxi"), device="cpu")
    problems = validate_sharding(_conf("fuxi"), mesh=Mesh(4), model=model)
    assert len(problems) == 1 and "model fuxi" in problems[0]
    with pytest.raises(ValueError, match="model fuxi"):
        assert_valid_sharding(_conf("fuxi"), mesh=Mesh(4), model=model)
    swin = load_model(_conf("swin"), device="cpu")
    problems = validate_sharding(_conf("swin"), mesh=Mesh(4), model=swin)
    assert sum("model swin" in p for p in problems) == 1


def test_tp_splits_every_model_with_an_ff_block():
    """At tensor 2 each model of the zoo with a CrossFormer FF or a SwinV2
    MLP holds the FF blocks' fc1 / fc2 kernels and fc1's bias as tp shares
    (the trainer's "computes the whole model" warning is for the others:
    unet, unet-diffusion, graph, debugger, whose names list is empty);
    fc2's bias and the SwinV2 post-norm LN stay whole on every rank."""
    from credit_torch.models import load_model
    from credit_torch.trainers.trainer import tp_partial_names
    from tests.test_torch_port_models import MODELS as ZOO

    confs = {name: ZOO[name][0] for name in ("camulator_ps", "crossformer_downscaling", "unet",
                                             "unet_downscaling", "debugger", "nextgen_wxformer",
                                             "wrf", "dscale", "graph", "crossformer-diffusion",
                                             "unet-diffusion")}
    confs.update({name: MODELS[name] for name in ("fuxi", "swin", "ensemble")})
    confs["crossformer"] = {**TINY_MODEL_CONF["model"], "dim_head": 8}
    whole = {"unet", "unet_downscaling", "unet-diffusion", "graph", "debugger"}
    for name, m in confs.items():
        names = tp_partial_names(load_model({"model": copy.deepcopy(m)}, device="cpu"), 2)
        ff = [k for k in names if re.search(r"(_ff\d+\.|mlp_)fc1\.kernel$", k)]
        assert bool(names) == bool(ff) == (name not in whole), name
        assert not any(re.search(r"(_ff\d+\.|mlp_)fc2\.bias$|norm2\.", k) for k in names), name

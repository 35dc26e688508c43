"""The port's training and rollouts on a mesh of processes, on the CPU.

Spawned gloo ranks (`torch_port_parallel_worker.py`, a FileStore under
tmp_path, a 60 s group timeout, 90-150 s a launch; every 2-rank case but
the fit in one launch, `pair`) run the tiny CrossFormer
(TINY_MODEL_CONF with 8-wide heads and the quadrant stage-0 embed:
2/4/8/16 heads, 32/16/8/4 rows a stage) on credit_tpu's numpy weights:

- one train step (MSE, AdamW with clip and decay) at (dp, tp, domain) =
  (2, 1, 1), (1, 1, 2), (1, 2, 1) and (2, 2, 2): the loss, the gradient
  the optimizer is given and the updated parameters against the same
  ranks' unsharded step and against credit_tpu's step on its (2, 1, 2)
  mesh with the explicit halo (its optax AdamW on its gradient);
- `run_training` of two processes through the CREDIT_* variables at
  data 2 against one process at batch 2 (training_log.csv cell by cell),
  its checkpoint (whole tensors) against the one process's and resumed at
  world size 1, and `run_rollout` from it, each rank its stride of the
  init times, file for file against one process;
- crossformer-ensemble with a trainable SKEBS postblock, one step through
  the Trainer at domain 2 against the Trainer without parallelism (the
  slab forward's noise drawn for the whole field; the postblock net's
  gradient, computed whole on each domain rank, counted once);
- a 4-process crossformer-ensemble `run_training` at (data 2, domain 2):
  each dp row draws its own train and validation noise, domain peers the
  same, and the checkpoint keeps each dp row's generator;
- make_scan_rollout on a (1, 1, 2) mesh against the unsharded one, and the
  debugger model on a (2, 1, 2) mesh against credit_tpu's on its (2, 1, 4)
  mesh (tests/test_round5_fixes.py's seam-parity setup).
"""

import copy
import csv
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from __graft_entry__ import TINY_MODEL_CONF
from credit_torch.applications import run_rollout, run_training
from credit_torch.data import zarrlite as tzarr
from credit_torch.data.channels import ChannelSchema as TSchema
from credit_torch.utils import ncio as tncio
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.ops import conv as jconv
from credit_tpu.parallel.mesh import build_mesh as jax_mesh
from credit_tpu.trainers import trainer as jtrainer
from credit_tpu.trainers.scheduler import load_scheduler as jax_scheduler
from tests.test_torch_port_model import _numpy_variables, _to_numpy
from torch_port_fixtures import (fit_conf, jit_lowopt, run_ranks, start_many,  # noqa: F401
                                 start_ranks, two_torch_threads, write_era5_store, write_stats)

DATA = {"source": {"ERA5": {"levels": [0.0, 1.0], "variables": {
    "prognostic": {"vars_3D": ["U", "T"], "vars_2D": ["SP", "T2M"]},
    "dynamic_forcing": {"vars_2D": ["TISR"]}, "diagnostic": {"vars_2D": ["PRECIP"]}}}},
    "forecast_len": 1, "history_len": 1}
MESHES = [(2, 1, 1), (1, 1, 2), (1, 2, 1), (2, 2, 2)]
TP_MESHES = [d for d in MESHES if d[1] > 1]
LR = 1e-3


def _conf():
    conf = copy.deepcopy(TINY_MODEL_CONF)
    conf["model"].update(dim_head=8, cross_embed_kernel_sizes=[[4, 8, 16, 32], [2, 4], [2, 4],
                                                               [2, 4]])
    return {**conf, "data": DATA, "trainer": {"learning_rate": LR, "weight_decay": 0.01,
                                              "grad_max_norm": 1.0}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _mesh_step(jm, conf, variables, x, y, dims):
    """credit_tpu's step on its own (dp, tp, domain) mesh with the explicit
    halo, x sharded as its batch_spec (compiled at XLA's lowest
    optimisation level): loss, gradients, AdamW-updated parameters."""
    jit = jit_lowopt
    mesh = jax_mesh(*dims, jax.devices()[:int(np.prod(dims))])

    def loss(params, xs):
        with jconv.explicit_halo(mesh):
            pred, _ = jm.apply({"params": params, "spectral": variables["spectral"]}, xs,
                               train=True, mutable=["spectral"])
        return jnp.mean((pred - y) ** 2)

    xs = jax.device_put(x, NamedSharding(mesh, P("dp", None, "domain", None, None)))
    val, grads = jit(jax.value_and_grad(loss))(variables["params"], xs)
    opt = jtrainer.make_optimizer(conf, jax_scheduler(conf))
    new = jit(lambda g, p: jax.tree_util.tree_map(
        lambda a, u: a + u, p, opt.update(g, opt.init(p), p)[0]))(grads, variables["params"])
    return {"loss": float(val), "grads": _flat(_to_numpy(grads)), "params": _flat(_to_numpy(new))}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """credit_tpu's weights, batch and step on its (2, 1, 2) mesh with the
    explicit halo: loss, gradients, AdamW-updated parameters; and under
    'tp' its steps on the meshes with tensor 2, (1, 2, 1) and (2, 2, 2).
    `pair`'s launch starts before those steps are computed and runs
    meanwhile ('pair_wait')."""
    root = tmp_path_factory.mktemp("train")
    conf = _conf()
    jm = jax_load_model(conf)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1, 32, 64, 7)).astype(np.float32)
    y = rng.standard_normal((2, 1, 32, 64, 7)).astype(np.float32)
    variables = _to_numpy(_numpy_variables(jm, x, 3))
    with open(root / "variables.pkl", "wb") as f:
        pickle.dump(variables, f)
    np.savez(root / "batch.npz", x=x, y=y)
    args = {"conf": conf, "variables": str(root / "variables.pkl"),
            "batch": str(root / "batch.npz")}
    pair_wait = _start_pair(args, tmp_path_factory.mktemp("pair"))
    tp = {d: _mesh_step(jm, conf, variables, x, y, d) for d in TP_MESHES}
    return {"root": root, "conf": conf, **_mesh_step(jm, conf, variables, x, y, (2, 1, 2)),
            "tp": tp, "args": args, "pair_wait": pair_wait}


def _start_pair(args: dict, root):
    """Launch every 2-rank case of the module but the fit in one launch:
    the train steps at the meshes of 2 ranks, the trainer steps at domain
    2 (`_domain2_conf`'s cases), the scan rollout at (1, 1, 2); returns
    the call that waits for it."""
    runs = [("train", {**args, "meshes": [d for d in MESHES if np.prod(d) == 2]})]
    for case in DOMAIN2_CASES:
        conf = _domain2_conf(case, root / case)
        schema = TSchema.from_config(conf)
        rng = np.random.default_rng(21)
        np.savez(root / f"{case}.npz",
                 x=rng.standard_normal((1, 1, 32, 64, schema.n_input)).astype(np.float32),
                 y=rng.standard_normal((1, 1, 32, 64, schema.n_target)).astype(np.float32))
        runs.append(("trainer_step", {"conf": conf, "batch": str(root / f"{case}.npz")}))
    runs.append(("rollout", {**args, "mesh": [1, 1, 2]}))
    return start_many(2, root, runs, timeout=240.0)


@pytest.fixture(scope="module")
def pair(ref):
    """`_start_pair`'s launch, which `ref` started."""
    out = ref["pair_wait"]()
    return {"train": out[0], "rollout": out[-1],
            **{case: out[1 + i] for i, case in enumerate(DOMAIN2_CASES)}}


@pytest.fixture(scope="module")
def steps(ref, pair, tmp_path_factory):
    """The meshes of 2 ranks (`pair`'s launch), (2, 2, 2) in a launch of 8,
    beside a tiny FuXi's step at (2, 2, 2) (`fuxi_tp`'s case, under
    'fuxi', credit_tpu's steps computed while the 8 run)."""
    out = {}
    eight = [d for d in MESHES if np.prod(d) == 8]
    root = tmp_path_factory.mktemp("step")
    case, fuxi_inputs = fuxi_tp(root)
    wait = start_many(8, root, [("train", {**ref["args"], "meshes": eight}),
                                ("swin_family", {"cases": [case]})], timeout=240.0)
    fuxi_ref = fuxi_tp_reference(*fuxi_inputs)
    train8, family8 = wait()
    for meshes in ([d for d in MESHES if np.prod(d) == 2], eight):
        ranks = pair["train"] if meshes != eight else train8
        for d in meshes:
            tag = "mesh" + "".join(map(str, d))
            out[d] = [{k.replace(tag, "mesh", 1): v for k, v in r.items()
                       if k.startswith(("one_", tag + "_", "mu_whole"))} for r in ranks]
    out["fuxi"] = (family8, fuxi_ref)
    return out


def fuxi_tp(root):
    """test_torch_port_parallel_fuxi.py's tiny FuXi at dim 64 (its SwinV2
    MLP kernels held as ZeRO-3 chunks at dp 2) at (2, 2, 2) on a batch of
    2: the worker's `swin_family` case, and `fuxi_tp_reference`'s
    arguments."""
    from tests import test_torch_port_parallel_fuxi as pf

    conf = pf._conf("fuxi_wide")
    jm = jax_load_model(conf)
    xshape, yshape = pf._shapes(conf["model"])
    rng = np.random.default_rng(60)
    x = rng.standard_normal((2, *xshape)).astype(np.float32)
    y = rng.standard_normal((2, *yshape)).astype(np.float32)
    variables = _to_numpy(_numpy_variables(jm, x, 3))
    with open(root / "fuxi.pkl", "wb") as f:
        pickle.dump(variables, f)
    np.savez(root / "fuxi.npz", x=x, y=y)
    case = {"tag": "fuxi222", "conf": conf, "variables": str(root / "fuxi.pkl"),
            "batch": str(root / "fuxi.npz"), "mesh": [2, 2, 2]}
    return case, (conf, variables, x, y)


def fuxi_tp_reference(conf, variables, x, y):
    """credit_tpu's step of `fuxi_tp`'s FuXi on its own (2, 2, 2) mesh and
    its unsharded step (under 'one')."""
    from tests import test_torch_port_parallel_fuxi as pf

    return {**pf._reference(conf, variables, x, y, (2, 2, 2)),
            "one": pf._reference(conf, variables, x, y, (1, 1, 1)),
            "start": _flat(variables["params"])}


def _grad_close(got: dict, want: dict, tol: float):
    """Each gradient within tol of its largest, where a tensor's largest
    counts as at least 1e-2 of the model's (some true gradients vanish: a
    position-bias output bias, a conv bias before GroupNorm); and the
    whole gradient's difference within tol of its norm."""
    gmax = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-2 * gmax)
        assert np.abs(got[k] - w).max() <= tol * scale, k
    num = np.sqrt(sum(((got[k] - w) ** 2).sum() for k, w in want.items()))
    den = np.sqrt(sum((w ** 2).sum() for w in want.values()))
    assert num <= tol * den


def _update_close(got: dict, want: dict, start: dict, grads: dict):
    """The AdamW step (parameter after minus before) within 1e-3 of the
    learning rate, outside the elements whose gradient is below 1e-4 of
    its tensor's largest, counted as at least 1e-2 of the model's (Adam's
    first step there is g / (|g| + eps), decided by rounding: a vanishing
    position-bias output bias)."""
    gmax = max(np.abs(v).max() for v in grads.values())
    for k, w in want.items():
        g = grads[k]
        mask = np.abs(g) > 1e-4 * max(np.abs(g).max(), 1e-2 * gmax)
        d = np.abs((got[k] - start[k]) - (w - start[k]))[mask]
        assert d.size == 0 or d.max() <= 1e-3 * LR, k


def _mine(rank: dict, tag: str, what: str) -> dict:
    pre = f"{tag}_{what}."
    return {k[len(pre):]: v for k, v in rank.items() if k.startswith(pre)}


@pytest.mark.parametrize("dims", MESHES)
def test_mesh_step_matches_unsharded(steps, ref, dims):
    """On every rank: the loss within 1e-6, the gradient within 1e-5, the
    update as `_update_close`; the optimizer moments held in chunks (dp or
    tp > 1: fewer elements than the parameters)."""
    start = {k: v for k, v in _flat(pickle.load(open(ref["args"]["variables"], "rb"))[
        "params"]).items()}
    for rank in steps[dims]:
        np.testing.assert_allclose(rank["mesh_loss"], rank["one_loss"], rtol=1e-6)
        one_g = _mine(rank, "one", "grad")
        _grad_close(_mine(rank, "mesh", "grad"), one_g, 1e-5)
        _update_close(_mine(rank, "mesh", "param"), _mine(rank, "one", "param"), start, one_g)
        assert int(rank["one_mu_chunks"]) == int(rank["mu_whole"])
        if dims[0] * dims[1] > 1:
            assert int(rank["mesh_mu_chunks"]) < int(rank["mu_whole"])
        else:
            assert int(rank["mesh_mu_chunks"]) == int(rank["mu_whole"])


@pytest.mark.parametrize("dims", MESHES)
def test_mesh_step_matches_reference_mesh_step(steps, ref, dims):
    """Against credit_tpu's (2, 1, 2) mesh step: the loss within 1e-5, the
    gradient within 1e-4 (XLA's and PyTorch's summation orders), the
    update as `_update_close`."""
    start = _flat(pickle.load(open(ref["args"]["variables"], "rb"))["params"])
    for rank in steps[dims]:
        np.testing.assert_allclose(rank["mesh_loss"], ref["loss"], rtol=1e-5)
        _grad_close(_mine(rank, "mesh", "grad"), ref["grads"], 1e-4)
        _update_close(_mine(rank, "mesh", "param"), ref["params"], start, ref["grads"])


@pytest.mark.parametrize("dims", TP_MESHES)
def test_tp_mesh_step_matches_reference_on_its_mesh(steps, ref, dims):
    """At tensor 2, against credit_tpu's step on the same mesh (its FF and
    attention partitioned by GSPMD from _TP_RULES): the loss within 1e-5,
    the gradient within 1e-4, the update as `_update_close`."""
    start = _flat(pickle.load(open(ref["args"]["variables"], "rb"))["params"])
    want = ref["tp"][dims]
    for rank in steps[dims]:
        np.testing.assert_allclose(rank["mesh_loss"], want["loss"], rtol=1e-5)
        _grad_close(_mine(rank, "mesh", "grad"), want["grads"], 1e-4)
        _update_close(_mine(rank, "mesh", "param"), want["params"], start, want["grads"])


@pytest.mark.parametrize("dims", TP_MESHES)
def test_tp_ff_runs_on_the_rank_slice(steps, dims):
    """At tensor 2 every FF call of the step, forward and backward, runs on
    half the hidden width it runs at unsharded, on each rank (the widths
    kernel 1's and kernel 4's wrappers were given)."""
    for rank in steps[dims]:
        one, mesh = rank["one_ff_hidden"], rank["mesh_ff_hidden"]
        assert len(one) == 17 and len(mesh) == len(one)  # 8 FF calls, forward and backward
        np.testing.assert_array_equal(mesh, np.where(one > 0, one // 2, one))


def test_fuxi_at_2_2_2_matches_unsharded_and_reference(steps):
    """The tiny FuXi at (dp, tp, domain) = (2, 2, 2), on each of the 8
    ranks: the loss within 1e-6 and the gradient within 1e-5 of the
    unsharded step, the update as `_update_close`; the loss within 1e-5 of
    credit_tpu's step on its own (2, 2, 2) mesh, and the gradient within
    1e-4 and the update of its unsharded step (as the CrossFormer's above:
    credit_tpu's (2, 2, 2) step gives the cube embed's, the Down- and
    UpBlock convs' gradients twice their value on every other mesh, its
    own unsharded one included; ROADMAP queue 3); each FF call at half its
    unsharded hidden width; ZeRO-3's chunks held between the steps, and
    each rank's fc1 / fc2 slices of the gathered MLP kernels saved for the
    backward as handles (not the gathered buffers), re-gathered once a
    block."""
    ranks, mesh_ref = steps["fuxi"]
    start, want = mesh_ref["start"], mesh_ref["one"]
    for rank in ranks:
        mesh, one = "mesh_fuxi222", "one_fuxi222"
        np.testing.assert_allclose(rank[f"{mesh}_loss"], rank[f"{one}_loss"], rtol=1e-6)
        one_g = _mine(rank, one, "grad")
        _grad_close(_mine(rank, mesh, "grad"), one_g, 1e-5)
        _update_close(_mine(rank, mesh, "param"), _mine(rank, one, "param"), start, one_g)
        np.testing.assert_allclose(rank[f"{mesh}_loss"], mesh_ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(rank[f"{mesh}_loss"], want["loss"], rtol=1e-5)
        _grad_close(_mine(rank, mesh, "grad"), want["grads"], 1e-4)
        _update_close(_mine(rank, mesh, "param"), want["params"], start, want["grads"])
        hid, hid1 = rank[f"{mesh}_ff_hidden"], rank[f"{one}_ff_hidden"]
        assert len(hid1) > 2 and len(hid) == len(hid1)
        np.testing.assert_array_equal(hid, np.where(hid1 > 0, hid1 // 2, hid1))
        params, grads, left = rank[f"{mesh}_resident"]
        assert params == grads == int(rank[f"{mesh}_expected_resident"]) and left == 0
        views, slices, regathers = rank[f"{mesh}_zero3_counts"]
        assert slices >= 4 and views >= slices  # 2 blocks' w1 and w2 slices at least
        assert 1 <= regathers <= 6  # at most once a block (the model has 6)


# --------------------------------------------------------------- run_training
@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The store; a 2-process run_training at data 2 and run_rollout from
    it; the same in this process while the two run."""
    root = tmp_path_factory.mktemp("pfit")
    store = write_era5_store(root / "era5.zarr", tzarr.write_array)
    stats = write_stats(root, tncio)

    def conf(tag, **trainer):
        c = fit_conf(store, stats, root / tag, **trainer)
        c["predict"] = {"forecasts": {"start_year": 1979, "start_month": 1, "start_day": 1,
                                      "start_hours": [6, 12, 18], "duration": 1},
                        "forecast_steps": 2, "save_forecast": str(root / tag / "fc")}
        return c

    two = conf("two", parallelism={"data": 2}, dist_timeout=60)
    wait = start_ranks("fit", 2, root, {"conf": two, "rollout": True}, timeout=120.0)
    one = conf("one")
    run_training(one, device="cpu")
    written = run_rollout(one, n_steps=2, device="cpu")
    wait()
    return {"root": root, "two": two, "one": one, "written": written, "conf": conf}


def _log(save_loc):
    with open(os.path.join(save_loc, "training_log.csv")) as f:
        return list(csv.reader(f))


def test_two_process_fit_matches_one_process(fits):
    """The two dp rows' log (every column but the seconds) within 1e-5
    relative of one process's batch of 2."""
    two, one = _log(fits["two"]["save_loc"]), _log(fits["one"]["save_loc"])
    assert two[0] == one[0] and len(two) == len(one) == 3
    for a, b in zip(two[1:], one[1:]):
        for name, u, v in zip(two[0], a, b):
            if name != "seconds":
                np.testing.assert_allclose(float(u), float(v), rtol=1e-5, atol=1e-7,
                                           err_msg=name)


def test_world_size_1_group_fit_matches_no_group(fits, monkeypatch):
    """run_training joined to a group of one (the CREDIT_* variables, a
    file:// rendezvous, gloo) at data: none runs the mesh step (the
    gradient and loss all-reduced over the group): its log equals the fit
    without a group, every column but the seconds within 1e-6."""
    import torch.distributed as dist

    from credit_torch.parallel import distributed as D

    conf = fits["conf"]("ws1", parallelism={"data": "none"}, dist_timeout=60)
    monkeypatch.setenv("CREDIT_COORDINATOR", f"file://{fits['root'] / 'ws1_store'}")
    monkeypatch.setenv("CREDIT_NUM_PROCESSES", "1")
    monkeypatch.setenv("CREDIT_PROCESS_ID", "0")
    D.COUNTS.clear()
    try:
        run_training(conf, device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert D.COUNTS["all_reduce"] >= 8  # 4 steps: gradient and loss; the validation metrics
    got, want = _log(conf["save_loc"]), _log(fits["one"]["save_loc"])
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        for name, u, v in zip(got[0], a, b):
            if name != "seconds":
                np.testing.assert_allclose(float(u), float(v), rtol=1e-6, atol=1e-8,
                                           err_msg=name)


def test_sharded_checkpoint_is_whole_and_resumes_at_world_size_1(fits):
    """The 2-process checkpoint holds whole tensors (moments and EMA of the
    parameters' shapes) close to one process's: the parameters together
    within 1e-5 of their norm, each element within 2 lr a step (Adam moves
    an element by at most lr a step, and the few whose gradient is
    rounding noise, a conv bias before GroupNorm, may move either way),
    the moments as `_grad_close` at 1e-4; and a run of one process resumes
    from it for one more epoch."""
    two = torch.load(os.path.join(fits["two"]["save_loc"], "checkpoint", "state.pt"),
                     weights_only=True)
    one = torch.load(os.path.join(fits["one"]["save_loc"], "checkpoint", "state.pt"),
                     weights_only=True)
    assert two["step"] == one["step"]
    lr = fits["one"]["trainer"]["learning_rate"]
    got = {k: v.numpy() for k, v in two["model"].items()}
    want = {k: v.numpy() for k, v in one["model"].items()}
    num = np.sqrt(sum(((got[k] - w) ** 2).sum() for k, w in want.items()))
    assert num <= 1e-5 * np.sqrt(sum((w ** 2).sum() for w in want.values()))
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 2 * lr * one["step"], k
    for part in ("mu", "nu"):
        w = {k: v.numpy() for k, v in one["opt_state"][part].items()}
        g = {k: v.numpy() for k, v in two["opt_state"][part].items()}
        assert all(g[k].shape == v.shape for k, v in w.items())
        _grad_close(g, w, 1e-4)
    for k, v in one["ema_params"].items():
        assert two["ema_params"][k].shape == v.shape
    resume = {**fits["two"], "trainer": {**fits["two"]["trainer"], "load_weights": True,
                                         "num_epoch": 1}}
    del resume["trainer"]["parallelism"]
    state = run_training(resume, device="cpu")
    assert state.step == two["step"] + 2
    log = _log(resume["save_loc"])
    assert len(log) == 4 and np.isfinite(float(log[-1][1]))


def test_rank_strided_rollout_matches_one_process(fits):
    """Two ranks each roll out their stride of the three init times; the
    files together are one process's, each within 1e-5."""
    from credit_torch.applications.experiment import diff_rollout

    base_two = fits["two"]["predict"]["save_forecast"]
    base_one = fits["one"]["predict"]["save_forecast"]
    two = sorted(os.path.relpath(p, base_two) for p in _walk(base_two))
    one = sorted(os.path.relpath(p, base_one) for p in fits["written"])
    assert two == one and len(one) == 6
    report = diff_rollout([os.path.join(base_two, p) for p in two], base_one, rtol=1e-5,
                          atol=1e-5)
    assert all(e["ok"] for e in report)


def _walk(d):
    return [os.path.join(a, f) for a, _, fs in os.walk(d) for f in fs if f.endswith(".nc")]


# --------------------------------------------------------------- noise
SKEBS_DATA = {"source": {"ERA5": {"levels": [0, 1], "variables": {
    "prognostic": {"vars_3D": ["U", "V", "T"], "vars_2D": ["SP", "U10", "V10"]},
    "dynamic_forcing": {"vars_2D": ["TISR"]}, "diagnostic": {"vars_2D": ["PRECIP"]}}}},
    "forecast_len": 1, "history_len": 1}
SKEBS = {"activate": True, "backscatter_net": {"type": "cnn"}, "max_pattern_wavenum": 8,
         "pattern_filter_anneal_start": 4, "max_backscatter_wavenum": 12,
         "backscatter_filter_anneal_start": 8}


def _domain2_conf(case: str, tmp_path) -> dict:
    conf = copy.deepcopy(TINY_MODEL_CONF)
    trainer = {"learning_rate": 1e-3, "parallelism": {"domain": 2}}
    if case == "ensemble_skebs":
        conf["model"].update(type="crossformer-ensemble", image_height=32, image_width=64,
                             levels=2, channels=3, surface_channels=3, input_only_channels=1,
                             output_only_channels=1,
                             post_conf={"activate": True, "skebs": SKEBS})
        return {**conf, "data": SKEBS_DATA, "save_loc": str(tmp_path), "trainer": trainer}
    conf["model"].update(type="crossformer-diffusion")
    return {**conf, "data": DATA, "save_loc": str(tmp_path), "diffusion": {"timesteps": 10},
            "trainer": {**trainer, "type": "era5-diffusion"}}


DOMAIN2_CASES = ("ensemble_skebs", "diffusion")


@pytest.mark.parametrize("case", DOMAIN2_CASES)
def test_trainer_step_domain2_matches_unsharded(pair, case):
    """One trainer step at domain 2 from the trainer's seeded state, on
    both ranks, against the same trainer class without parallelism: the
    loss within 1e-6 and the gradient within 1e-5 (`_grad_close`).
    `ensemble_skebs`: crossformer-ensemble (its noise on the slabs, each
    rank's rows of the whole field's draws) with SKEBS and its learned cnn
    rate on the gathered prediction, the postblock net's gradient within
    1e-5 of its largest (the domain ranks each compute it whole: summed
    over them, it is counted once). `diffusion`: the era5-diffusion
    trainer's step, its CrossFormer denoiser lat-sharded."""
    for rank in pair[case]:
        np.testing.assert_allclose(rank["mesh_loss"], rank["one_loss"], rtol=1e-6)
        one, mesh = _mine(rank, "one", "grad"), _mine(rank, "mesh", "grad")
        assert one.keys() == mesh.keys()
        net = [k for k in one if k.startswith("_postblocks.")]
        if case == "ensemble_skebs":
            assert net and any(k.startswith("noise_inject") for k in one)
        _grad_close(mesh, one, 1e-5)
        for k in net:
            assert np.abs(mesh[k] - one[k]).max() <= 1e-5 * np.abs(one[k]).max(), k


def test_dp_rows_draw_their_own_noise(tmp_path):
    """crossformer-ensemble run_training of 4 processes at data 2, domain 2
    (ranks 0, 1 dp row 0; 2, 3 row 1): in the train step and in
    validation, the latent and the pixel noise each rank drew are its
    domain peer's exactly and differ from the other dp row's; the
    checkpoint holds each row's generator state, the two different."""
    store = write_era5_store(tmp_path / "era5.zarr", tzarr.write_array)
    stats = write_stats(tmp_path, tncio)
    conf = fit_conf(store, stats, tmp_path / "run", parallelism={"data": 2, "domain": 2},
                    num_epoch=1, batches_per_epoch=1, dist_timeout=60)
    conf["model"]["type"] = "crossformer-ensemble"
    ranks = run_ranks("fit", 4, tmp_path, {"conf": conf, "draws": True}, timeout=150.0)
    for key in ("train_latent", "train_pixel", "valid_latent", "valid_pixel"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
        np.testing.assert_array_equal(ranks[2][key], ranks[3][key], err_msg=key)
        assert ranks[0][key].shape == ranks[2][key].shape
        assert not np.allclose(ranks[0][key], ranks[2][key]), key
    saved = torch.load(os.path.join(conf["save_loc"], "checkpoint", "state.pt"),
                       weights_only=True)
    assert len(saved["noise_dp"]) == 2
    assert torch.equal(saved["noise_dp"][0], saved["noise"])
    assert not torch.equal(saved["noise_dp"][0], saved["noise_dp"][1])


# --------------------------------------------------------------- rollouts
def test_mesh_scan_rollout_matches_unsharded(pair):
    for r in pair["rollout"]:
        np.testing.assert_allclose(r["mesh_x"], r["one_x"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["mesh_stats"], r["one_stats"], rtol=1e-5, atol=1e-6)


def test_mesh_scan_rollout_seam_parity_with_reference(tmp_path):
    """tests/test_round5_fixes.py:254's setup: the debugger model, 3 steps;
    the port on a (2, 1, 2) mesh (each dp row its half of the batch, each
    domain rank its latitude slab), credit_tpu on its (2, 1, 4) mesh;
    within 1e-5."""
    from credit_tpu.data.channels import ChannelSchema
    from credit_tpu.rollout import make_scan_rollout

    conf = {"model": {"type": "debugger", "image_height": 16, "image_width": 24,
                      "channels": 0, "surface_channels": 2, "levels": 0,
                      "input_only_channels": 0, "output_only_channels": 0},
            "data": {"source": {"ERA5": {"variables": {"prognostic": {"vars_2D": ["T2M", "SP"]}}}}}}
    schema = ChannelSchema.from_config(conf)
    model = jax_load_model(conf)
    x0 = np.random.default_rng(17).standard_normal((2, 1, 16, 24, schema.n_input)).astype(
        np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x0))
    with open(tmp_path / "variables.pkl", "wb") as f:
        pickle.dump(_to_numpy(variables), f)
    np.savez(tmp_path / "batch.npz", x=x0)
    wait = start_ranks("rollout", 4, tmp_path, {"conf": conf, "mesh": [2, 1, 2],
                                                "variables": str(tmp_path / "variables.pkl"),
                                                "batch": str(tmp_path / "batch.npz")})
    mesh = jax_mesh(2, 1, 4)
    roll = make_scan_rollout(model, schema, 3, history_len=1, with_forcing=False, mesh=mesh)
    xs = jax.device_put(jnp.asarray(x0), NamedSharding(mesh, P("dp", None, "domain", None, None)))
    want, _ = jax.jit(roll)(jax.device_put(variables, NamedSharding(mesh, P())), xs)
    for r in wait():
        np.testing.assert_allclose(r["mesh_x"], np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["one_x"], np.asarray(want), rtol=1e-5, atol=1e-5)

"""One rank of the port's multi-process CPU tests (gloo over a FileStore).

    python torch_port_parallel_worker.py SCENARIO RANK WORLD STORE OUT_DIR ARGS.json

Each rank joins the group (timeout 60 s), runs SCENARIO and writes
OUT_DIR/<scenario>_rank<RANK>.npz; the test holds the files against the
unsharded port and credit_tpu. Imports torch and credit_torch only.
Scenarios: `ops` (halo exchange, group-norm moments, ring-CRPS, the conv
seams), `train` (one tiny CrossFormer train step on a mesh, and the
unsharded step), `trainer_step` (one step through a Trainer on its
trainer.parallelism mesh, and through one without), `fit` (run_training,
then run_rollout, through the CREDIT_* variables, recording a noisy
model's draws), `rollout` (make_scan_rollout on a mesh), `swin_family`
(the SwinV2 family's forward and train step on a mesh against unsharded),
`zero3` (ZeRO-3 through the Trainer, its checkpoint resumed at world size
1), `zoo` (the other lat-sharded models: NextGen, the U-Net family, graph,
debugger) and `many` (several of these in one launch).
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _join(rank: int, world: int, store: str):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def scenario_ops(rank: int, world: int, args: dict) -> dict:
    """domain = world for the halo, moments and convs; dp = world for
    ring-CRPS. Each input is the global seeded array; a rank's outputs are
    its slab's (and its all-reduced weight gradients)."""
    import torch

    from credit_torch.losses import ring_crps_loss
    from credit_torch.ops import conv as conv_ops
    from credit_torch.parallel import context as par_ctx
    from credit_torch.parallel import distributed as D
    from credit_torch.parallel.halo import (distributed_group_norm_moments, halo_exchange,
                                            shard_lat)
    from credit_torch.parallel.mesh import build_mesh
    from credit_torch.parallel.ring_crps import dense_fair_crps, make_ring_crps_loss

    out = {}
    dom = build_mesh(1, 1, world)
    group = dom.group("domain")
    for halo in (1, 2):
        x = np.random.default_rng(halo).standard_normal((2, 4 * world, 6, 3)).astype(np.float32)
        ct = np.random.default_rng(10 + halo).standard_normal(
            (2, (4 + 2 * halo) * world, 6, 3)).astype(np.float32)
        xs = shard_lat(_t(x), world, rank).clone().requires_grad_(True)
        y = halo_exchange(xs, halo, group)
        (y * shard_lat(_t(ct), world, rank)).sum().backward()
        out[f"halo{halo}_y"], out[f"halo{halo}_g"] = y.detach().numpy(), xs.grad.numpy()
    x = np.random.default_rng(3).standard_normal((2, 4 * world, 6, 8)).astype(np.float32)
    mean, var = distributed_group_norm_moments(shard_lat(_t(x), world, rank), 4, group)
    out["gn_mean"], out["gn_var"] = mean.numpy(), var.numpy()

    dpm = build_mesh(world, 1, 1)
    rng = np.random.default_rng(4)
    members = rng.standard_normal((world, 5, 6)).astype(np.float32)
    target = rng.standard_normal((5, 6)).astype(np.float32)
    mem = _t(members).requires_grad_(True)
    loss = make_ring_crps_loss(dpm.group("dp"))(mem, _t(target))
    loss.backward()
    out["ring_loss"], out["ring_grad"] = loss.detach().numpy(), mem.grad.numpy()
    m_r = _t(members[rank]).requires_grad_(True)
    out["ring_registry"] = ring_crps_loss(_t(target), m_r,
                                          axis_name=dpm.group("dp")).detach().numpy()
    out["dense"] = dense_fair_crps(_t(members), _t(target)).numpy()

    for i, (name, case) in enumerate(CONV_CASES.items()):
        xshape, kshape, kind, stride, pad = case
        rng = np.random.default_rng(100 + i)
        x = rng.standard_normal(xshape).astype(np.float32)
        k = (0.2 * rng.standard_normal(kshape)).astype(np.float32)
        b = rng.standard_normal(kshape[-1]).astype(np.float32)
        fn = conv_ops.conv2d if kind == "conv" else conv_ops.conv_transpose2d
        ref = fn(_t(x), _t(k), _t(b), stride, pad)
        ct = np.random.default_rng(7).standard_normal(tuple(ref.shape)).astype(np.float32)
        xs = shard_lat(_t(x), world, rank).clone().requires_grad_(True)
        kt, bt = _t(k).requires_grad_(True), _t(b).requires_grad_(True)
        D.COUNTS.clear()
        with par_ctx.explicit_halo(dom), par_ctx.lat_slabs():
            y = fn(xs, kt, bt, stride, pad)
        (y * shard_lat(_t(ct), world, rank)).sum().backward()
        out[f"{name}_y"], out[f"{name}_gx"] = y.detach().numpy(), xs.grad.numpy()
        out[f"{name}_gk"] = D.all_reduce(kt.grad, group).numpy()
        out[f"{name}_gb"] = D.all_reduce(bt.grad, group).numpy()
        out[f"{name}_gathers"] = np.asarray(D.COUNTS["all_gather"])

    _uneven_slabs(out, rank, world, group)

    from credit_torch.applications.benchmark import benchmark_halo, benchmark_parallelism

    halo = benchmark_halo(h=16, w=12, c=4, k=3, steps=3, device="cpu")
    out["bench_halo_err"] = np.asarray([halo["fwd_err_explicit"], halo["grad_err_explicit"]])
    out["bench_halo_p2p"] = np.asarray(halo["collectives_explicit"].get("p2p", 0))
    rows = benchmark_parallelism(args["bench_conf"], steps=1, warmup=0, device="cpu")
    from credit_torch.models import load_model

    mods = list(load_model(args["bench_conf"], device="cpu").modules())
    out["bench_attn_params"] = np.asarray(sum(len(list(m.parameters())) for m in mods
                                              if type(m).__name__ == "WindowAttention"))
    out["bench_ff_blocks"] = np.asarray(sum(type(m).__name__ == "FeedForward" for m in mods))
    out["bench_rows"] = np.asarray([[r["dp"], r["tensor"], r["domain"], r["step_ms"],
                                     r["samples_per_s"], r["gridpoints_per_s_per_chip"],
                                     r["loss"], r["scaling_efficiency"],
                                     r["tp_split_params"]] for r in rows])
    return out


# uneven slabs of a 4-rank field of 11 rows (window-aligned for windows of
# 1 row), and the even split of 12
UNEVEN = (3, 3, 3, 2)


def _uneven_slabs(out: dict, rank: int, world: int, group) -> None:
    """lat_roll by -2 and +1 on even and uneven slabs, reslab from even to
    uneven slabs, gather_lat of uneven slabs (with and without
    same_downstream): each rank's output and its input's gradient of
    <out, ct>, for the test to hold against torch.roll and slicing."""
    from credit_torch.parallel.halo import gather_lat, lat_roll, reslab, shard_lat

    for tag, counts in (("even", (3,) * world), ("uneven", UNEVEN)):
        h = sum(counts)
        x = np.random.default_rng(30).standard_normal((2, h, 5, 3)).astype(np.float32)
        ct = np.random.default_rng(31).standard_normal((2, h, 5, 3)).astype(np.float32)
        for shift in (-2, 1):
            xs = shard_lat(_t(x), world, rank, counts).clone().requires_grad_(True)
            y = lat_roll(xs, shift, group)
            (y * shard_lat(_t(ct), world, rank, counts)).sum().backward()
            out[f"roll_{tag}{shift}_y"], out[f"roll_{tag}{shift}_g"] = (y.detach().numpy(),
                                                                       xs.grad.numpy())
    x = np.random.default_rng(32).standard_normal((2, 12, 5, 3)).astype(np.float32)
    ct = np.random.default_rng(33).standard_normal((2, 12, 5, 3)).astype(np.float32)
    dst = (4, 4, 2, 2)
    xs = shard_lat(_t(x), world, rank).clone().requires_grad_(True)
    y = reslab(xs, (3,) * world, dst, group)
    (y * shard_lat(_t(ct), world, rank, dst)).sum().backward()
    out["reslab_y"], out["reslab_g"] = y.detach().numpy(), xs.grad.numpy()
    for same in (False, True):
        xs = shard_lat(_t(x[:, :11]), world, rank, UNEVEN).clone().requires_grad_(True)
        y = gather_lat(xs, group, same_downstream=same, counts=UNEVEN)
        (y * _t(ct[:, :11])).sum().backward()
        out[f"gather_uneven{int(same)}_y"] = y.detach().numpy()
        out[f"gather_uneven{int(same)}_g"] = xs.grad.numpy()


# name -> (x shape, kernel shape (kh, kw, in, out), conv or transpose, stride,
# padding); the slabs are x's rows over 4 ranks
CONV_CASES = {
    "halo_3x3": ((2, 16, 12, 4), (3, 3, 4, 5), "conv", 1, 1),
    "s2d_4x4": ((2, 16, 12, 4), (4, 4, 4, 5), "conv", 2, 1),
    "s2d_odd_3x3": ((2, 16, 12, 4), (3, 3, 4, 5), "conv", 2, 1),
    "transpose_k2": ((2, 8, 6, 4), (2, 2, 4, 5), "transpose", 2, 0),
    "transpose_k4": ((2, 8, 6, 4), (4, 4, 4, 5), "transpose", 2, 1),
    "gather_5x5": ((2, 4, 12, 4), (5, 5, 4, 5), "conv", 1, 2),
    "gather_s2_8x8": ((2, 8, 12, 4), (8, 8, 4, 5), "conv", 2, 3),
}


def _tiny(args: dict):
    """The tiny CrossFormer config, its port model with the given numpy
    variables (credit_tpu's tree), the seeded batch. With args['noise'] (a
    noisy model's credit_tpu draws, .npz) every forward of the model takes
    those draws (the generator it is given is not used)."""
    from credit_torch.convert_jax import from_jax_variables
    from credit_torch.models import load_model

    conf = args["conf"]
    with open(args["variables"], "rb") as f:
        variables = pickle.load(f)
    model = load_model(conf, device="cpu", sn_state=True)
    model.load_state_dict(from_jax_variables(variables, conf, device="cpu", fold=False))
    if args.get("noise"):
        draws = {k: _t(v) for k, v in np.load(args["noise"]).items()}
        forward = type(model).forward
        model.forward = lambda x, noise=None, generator=None: forward(model, x, noise=draws)
    batch = np.load(args["batch"])
    return conf, model, {k: _t(batch[k]) for k in batch.files}


def _ff_widths(fn):
    """fn() with kernel 1's wrappers recording the hidden width of every FF
    call (fused_ff: the whole hidden layer; ff_partial: a tp rank's slice)
    and kernel 4's (fused_ff_bwd, ff_partial_bwd): (fn's result, the
    forward's widths, the backward's)."""
    from credit_torch.ops import cuda_ff

    saved = {k: getattr(cuda_ff, k) for k in ("fused_ff", "ff_partial", "fused_ff_bwd",
                                                "ff_partial_bwd")}
    fwd, bwd = [], []

    def rec(name, into, at):
        def call(*a, **kw):
            into.append(int(a[at].shape[1]))
            return saved[name](*a, **kw)
        return call

    cuda_ff.fused_ff, cuda_ff.ff_partial = rec("fused_ff", fwd, 3), rec("ff_partial", fwd, 3)
    cuda_ff.fused_ff_bwd = rec("fused_ff_bwd", bwd, 4)
    cuda_ff.ff_partial_bwd = rec("ff_partial_bwd", bwd, 4)
    try:
        out = fn()
    finally:
        for k, v in saved.items():
            setattr(cuda_ff, k, v)
    return out, sorted(fwd), sorted(bwd)


def _step_on(conf, model, batch, mesh, steps: int = 1, out=None, tag="", ckpt=None):
    """`steps` train steps (MSE, the config's AdamW) of `model` on `mesh`
    (None: unsharded) through make_train_step, this rank's dp rows of
    `batch`; into `out` under `tag`: the loss, the (reduced, whole)
    gradients the optimizer was given at the last step and the updated
    (whole) parameters, the collectives, the optimizer's moment elements,
    and, between the steps, the parameter elements the model holds, the
    gradient elements the optimizer was given and the gradients left on
    the parameters, and the hidden widths of the first step's FF calls
    (`_ff_widths`: the forward's, -1, the backward's). With `ckpt` (a
    directory) the state after the first step is saved there through a
    Trainer's save_checkpoint."""
    import torch

    from credit_torch.data.channels import ChannelSchema
    from credit_torch.parallel import distributed as D
    from credit_torch.parallel.sharding import ShardedOptimizer, param_shards, shard_batch
    from credit_torch.trainers.scheduler import load_scheduler
    from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step

    schema = ChannelSchema.from_config(conf)

    def mse(y, p):
        return torch.mean((p - y) ** 2)

    opt = make_optimizer(conf, load_scheduler(conf))
    names = [k for k, _ in model.named_parameters()]
    if mesh is not None:
        opt = ShardedOptimizer(opt, mesh, names, [tuple(p.shape) for p in model.parameters()])
    seen = {}
    inner_update = opt.update

    def update(grads, st, params):
        seen["g"] = [g.clone() for g in grads]
        return inner_update(grads, st, params)

    opt.update = update
    step = make_train_step(model, mse, opt, schema, device="cpu", mesh=mesh)
    state = TrainState.create(model, opt)
    b = batch if mesh is None else shard_batch(batch, mesh)
    D.COUNTS.clear()
    for i in range(steps):
        (state, metrics), fwd, bwd = _ff_widths(lambda: step(state, b))
        if i == 0:  # the hidden widths of the FF calls, forward and backward
            out[f"{tag}_ff_hidden"] = np.asarray(fwd + [-1] + bwd)
        if i == 0 and ckpt is not None:
            _save(conf, model, opt, state, mesh, ckpt)
    shards = param_shards(model)
    if shards is not None:  # ZeRO-3: the handles saved for the backward, its re-gathers
        out[f"{tag}_zero3_counts"] = np.asarray([shards.counts[k] for k in (
            "saved_views", "saved_slices", "regathers")])
    grads, params = seen["g"], [p.detach() for _, p in model.named_parameters()]
    out[f"{tag}_resident"] = np.asarray([sum(p.numel() for p in params),
                                         sum(g.numel() for g in grads),
                                         sum(p.grad is not None for p in model.parameters())])
    if mesh is not None:
        grads = opt.held_whole(dict(zip(names, grads)))
        params = opt.held_whole(dict(zip(names, params)))
    out[f"{tag}_loss"] = metrics["loss"].numpy()
    for k, g, p in zip(names, grads, params):
        out[f"{tag}_grad.{k}"] = g.numpy()
        out[f"{tag}_param.{k}"] = p.numpy()
    out[f"{tag}_collectives"] = np.asarray(sum(D.COUNTS.values()))
    out[f"{tag}_mu_chunks"] = np.asarray(sum(v.numel() for v in state.opt_state["mu"].values()))
    return state


def _save(conf, model, opt, state, mesh, root):
    """state through Trainer.save_checkpoint (a trainer of `conf` made
    around the given model, optimizer and mesh)."""
    from credit_torch.trainers.trainer import Trainer

    trainer = Trainer.__new__(Trainer)
    trainer.conf, trainer.save_loc, trainer.mesh, trainer.optimizer = conf, root, mesh, opt
    trainer.dp = mesh.shape["dp"] if mesh is not None else 1
    trainer.tp = trainer.domain = 1
    trainer.device = next(model.parameters()).device
    trainer.save_checkpoint(state, 0)


def _expected_resident(model, mesh) -> int:
    """The elements a rank holds under ZeRO-3: each tensor of the (whole)
    model's parameters as its dp chunk where param_spec shards it over dp,
    else whole."""
    from credit_torch.parallel.sharding import param_spec

    total = 0
    for k, p in model.named_parameters():
        n = p.numel()
        total += n // mesh.shape["dp"] if "dp" in param_spec(k, tuple(p.shape), mesh) else n
    return total


def scenario_train(rank: int, world: int, args: dict) -> dict:
    """The unsharded step, then the same step on each mesh of
    args['meshes'] ((dp, tp, domain) lists), each on a fresh model of the
    same weights: `_step_on`'s outputs prefixed 'one_' or
    'mesh<dp><tp><domain>_', and each mesh's expected resident elements."""
    from credit_torch.parallel.mesh import build_mesh

    conf, model, batch = _tiny(args)
    out = {"mu_whole": np.asarray(sum(p.numel() for p in model.parameters()))}
    runs = [("one", None)] + [("mesh" + "".join(map(str, d)), build_mesh(*d))
                              for d in args["meshes"]]
    for tag, mesh in runs:
        if mesh is not None:
            out[f"{tag}_expected_resident"] = np.asarray(_expected_resident(model, mesh))
        _step_on(conf, model, batch, mesh, out=out, tag=tag)
        conf, model, batch = _tiny(args)
    return out


def scenario_trainer_step(rank: int, world: int, args: dict) -> dict:
    """One train step of args['conf'] (its trainer.parallelism over the
    group) through its trainer class's `_train_step_for`, from the
    trainer's seeded state, then the same through a trainer of the conf
    without parallelism: the loss and the (reduced, whole) gradient the
    optimizer was given, prefixed 'mesh_' and 'one_'."""
    import torch

    from credit_torch.data.channels import ChannelSchema
    from credit_torch.data.synthetic import SyntheticDataset
    from credit_torch.grid import Grid
    from credit_torch.losses import WeightedLoss
    from credit_torch.models import load_model
    from credit_torch.trainers.trainer import load_trainer

    conf = args["conf"]
    schema = ChannelSchema.from_config(conf)
    h, w = conf["model"]["image_height"], conf["model"]["image_width"]
    dataset = SyntheticDataset(schema, Grid.regular(h, w), n_times=4)
    batch = {k: _t(v) for k, v in np.load(args["batch"]).items()}
    out = {}
    single = {**conf, "trainer": {k: v for k, v in conf["trainer"].items()
                                  if k != "parallelism"}}
    for tag, c in (("mesh", conf), ("one", single)):
        model = load_model(c, device="cpu", sn_state=True)
        trainer = load_trainer(c)(c, model, WeightedLoss(), WeightedLoss(), schema, dataset,
                                  device="cpu")
        state = trainer.init_state(torch.Generator().manual_seed(3), noise_seed=4)
        seen, inner = {}, trainer.optimizer.update

        def update(grads, st, params, inner=inner, seen=seen):
            seen["g"] = [g.clone() for g in grads]
            return inner(grads, st, params)

        trainer.optimizer.update = update
        _, metrics = trainer._train_step_for(1)(state, batch)
        out[f"{tag}_loss"] = metrics["loss"].numpy()
        for k, g in zip(state.opt_state["mu"], seen["g"]):
            out[f"{tag}_grad.{k}"] = g.numpy()
    return out


def _kernel_rows(fn):
    """fn() with kernel 2's and kernel 1's wrappers recording their
    inputs, and the gather path (`context.on_full`) counted: (fn's
    result, the largest conv input's rows, the largest FF input's rows,
    the gather paths taken)."""
    from credit_torch.ops import cuda_conv, cuda_ff
    from credit_torch.parallel import context as par_ctx

    conv0, ff0, full0 = cuda_conv.conv2d_valid, cuda_ff.fused_ff, par_ctx.on_full
    rows = {"conv": [0], "ff": [0], "full": 0}

    def conv(x, k):
        rows["conv"].append(x.shape[1])
        return conv0(x, k)

    def ff(x, *a, **kw):
        rows["ff"].append(int(np.prod(x.shape[:-1])))
        return ff0(x, *a, **kw)

    def full(*a, **kw):
        rows["full"] += 1
        return full0(*a, **kw)

    cuda_conv.conv2d_valid, cuda_ff.fused_ff, par_ctx.on_full = conv, ff, full
    try:
        out = fn()
    finally:
        cuda_conv.conv2d_valid, cuda_ff.fused_ff, par_ctx.on_full = conv0, ff0, full0
    return out, max(rows["conv"]), max(rows["ff"]), rows["full"]


def scenario_swin_family(rank: int, world: int, args: dict) -> dict:
    """Per case of args['cases'] (a model of credit_tpu's numpy weights and
    a seeded batch, a mesh): `_family_case`'s outputs."""
    meshes, out = {}, {}
    for case in args["cases"]:
        _family_case(case, meshes, out)
    return out


def _family_case(case: dict, meshes: dict, out: dict):
    """The eval-mode forward of the case's model on its mesh and unsharded
    ('<tag>_pred_mesh', '<tag>_pred_one') with each side's largest kernel
    2 and kernel 1 inputs and its gather paths ('<tag>_rows_mesh' /
    '_one'), then `_step_on`'s outputs of the unsharded step
    ('one_<tag>') and of the mesh step ('mesh_<tag>'), each on a fresh
    model of the same weights. Returns (the mesh, this rank's batch)."""
    import torch

    from credit_torch.parallel import context as par_ctx
    from credit_torch.parallel.mesh import build_mesh
    from credit_torch.parallel.sharding import shard_batch

    tag, dims = case["tag"], tuple(case["mesh"])
    if dims not in meshes:
        meshes[dims] = build_mesh(*dims)
    mesh = meshes[dims]
    conf, model, batch = _tiny(case)
    model.eval()
    mine = shard_batch(batch, mesh)
    with torch.no_grad():
        one = _kernel_rows(lambda: model(batch["x"]))
        with par_ctx.explicit_halo(mesh):
            got = _kernel_rows(lambda: model(mine["x"]))
    out[f"{tag}_pred_one"], out[f"{tag}_pred_mesh"] = one[0].numpy(), got[0].numpy()
    out[f"{tag}_rows_one"], out[f"{tag}_rows_mesh"] = np.asarray(one[1:]), np.asarray(got[1:])
    _step_on(conf, model, batch, None, out=out, tag=f"one_{tag}")
    _, model, _ = _tiny(case)
    if dims[0] > 1:
        out[f"mesh_{tag}_expected_resident"] = np.asarray(_expected_resident(model, mesh))
    _step_on(conf, model, batch, mesh, out=out, tag=f"mesh_{tag}")
    return mesh, mine


def _sites(counter) -> np.ndarray:
    """A Counter of gather paths by site as a (site, count) string array."""
    return np.asarray(sorted(f"{k}:{v}" for k, v in counter.items() if v), dtype=str)


def scenario_zoo(rank: int, world: int, args: dict) -> dict:
    """The models lat-sharded in the zoo's last slice. Per case of
    args['cases']: `_family_case`'s outputs, plus the gather paths taken
    by site in the mesh forward and in the mesh step ('<tag>_gathers_fwd'
    / '_step', from `context.GATHERS`), the bottleneck's all-reduces of
    the mesh step ('<tag>_slab_sums'), for the graph this rank's edges,
    all edges and the halo ('<tag>_edges'), and for NextGen this rank's
    own (not yet reduced) agg_w / scatter_w gradients of an eval-mode
    MSE backward on the mesh and the same unsharded ('<tag>_raw_<name>_
    mesh' / '_one'). args['trainer_step']: `scenario_trainer_step`'s
    outputs ('ts_' prefixed). args['rollout']: a RolloutEngine of a case's
    folded model, 3 steps, on its mesh and unsharded ('rollout_mesh' /
    '_one')."""
    import torch

    from credit_torch.parallel import context as par_ctx

    meshes, out = {}, {}
    for case in args["cases"]:
        tag = case["tag"]
        par_ctx.GATHERS.clear()
        mesh, mine = _family_case(case, meshes, out)
        both = par_ctx.GATHERS.copy()  # the eval forward's and the mesh step's
        _, model, batch = _tiny(case)
        model.eval()
        par_ctx.GATHERS.clear()
        with torch.no_grad(), par_ctx.explicit_halo(mesh):
            model(mine["x"])
        out[f"{tag}_gathers_fwd"] = _sites(par_ctx.GATHERS)
        out[f"{tag}_gathers_step"] = _sites(both - par_ctx.GATHERS)
        bottleneck = getattr(model, "spectral_bottleneck", None)
        if bottleneck is not None:
            sums = bottleneck.slab_sums
            for side, m_, b in (("one", None, batch), ("mesh", mesh, mine)):
                model.zero_grad()
                with par_ctx.explicit_halo(m_):
                    torch.mean((model(b["x"]) - b["y"]) ** 2).backward()
                for name in ("agg_w", "scatter_w"):
                    out[f"{tag}_raw_{name}_{side}"] = getattr(bottleneck, name).grad.numpy()
            out[f"{tag}_slab_sums"] = np.asarray(bottleneck.slab_sums - sums)
        if hasattr(model, "slab_edges"):
            n, r = mesh.shape["domain"], mesh.coord("domain")
            out[f"{tag}_edges"] = np.asarray([len(model.slab_edges(n, r)[0]),
                                              len(model.edge_src), model.edge_halo])
    if args.get("trainer_step"):
        out.update((f"ts_{k}", v) for k, v in scenario_trainer_step(
            rank, world, args["trainer_step"]).items())
    if args.get("rollout"):
        out.update(_engine_rollout(args["rollout"]))
    return out


def _engine_rollout(case: dict) -> dict:
    """RolloutEngine.run of the case's model (credit_tpu's numpy weights,
    spectral norm folded), 3 steps from its batch's x, on its mesh and
    unsharded."""
    from credit_torch.convert_jax import from_jax_variables
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.models import load_model
    from credit_torch.parallel.mesh import build_mesh
    from credit_torch.rollout import RolloutEngine

    conf = case["conf"]
    with open(case["variables"], "rb") as f:
        variables = pickle.load(f)
    model = load_model(conf, device="cpu")
    model.load_state_dict(from_jax_variables(variables, conf, device="cpu"))
    schema = ChannelSchema.from_config(conf)
    x0 = np.load(case["batch"])["x"]
    out = {}
    for tag, mesh in (("one", None), ("mesh", build_mesh(*case["mesh"]))):
        engine = RolloutEngine(model, schema, history_len=conf["data"]["history_len"],
                               device="cpu", mesh=mesh)
        out[f"rollout_{tag}"] = np.stack(engine.run(x0, 3))
        engine.close()
    return out


def scenario_zero3(rank: int, world: int, args: dict) -> dict:
    """ZeRO-3 through the Trainer, per case of args['cases'] (a model
    config at data 2 with a seeded batch of 2): from the trainer's seeded
    state, a step on the mesh (this rank's row; with sn_external the power
    iterations before it, as fit runs them), a checkpoint, a second step: each step's loss, the first step's (reduced, whole) gradient,
    the resident elements between the steps (`_step_on`'s) against the
    expected chunks, the whole parameters after. Rank 0 then resumes the
    checkpoint in a trainer without parallelism for the second step on the
    whole batch, and runs both steps uninterrupted in another: the
    losses, the first step's gradient and the parameters after, prefixed
    'resumed_' and 'one_'."""
    import torch

    from credit_torch.data.channels import ChannelSchema
    from credit_torch.data.synthetic import SyntheticDataset
    from credit_torch.grid import Grid
    from credit_torch.losses import WeightedLoss
    from credit_torch.models import load_model
    from credit_torch.parallel.sharding import shard_batch
    from credit_torch.convert_jax import seed_train_
    from credit_torch.trainers.trainer import load_trainer, power_iterations

    out = {}
    for case in args["cases"]:
        tag, conf = case["tag"], case["conf"]
        schema = ChannelSchema.from_config(conf)
        h, w = conf["model"]["image_height"], conf["model"]["image_width"]
        dataset = SyntheticDataset(schema, Grid.regular(h, w), n_times=4)
        batch = {k: _t(v) for k, v in np.load(case["batch"]).items()}
        single = {**conf, "trainer": {k: v for k, v in conf["trainer"].items()
                                      if k != "parallelism"}}

        def trainer_of(c, root):
            model = load_model(c, device="cpu", sn_state=True)
            tr = load_trainer(c)(c, model, WeightedLoss(), WeightedLoss(), schema, dataset,
                                 save_loc=root, device="cpu")
            state = tr.init_state(torch.Generator().manual_seed(3), noise_seed=4)
            seen, inner = {}, tr.optimizer.update

            def update(grads, st, params, inner=inner, seen=seen):
                seen.setdefault("g", [g.clone() for g in grads])
                return inner(grads, st, params)

            tr.optimizer.update = update
            return tr, state, seen

        def step_of(tr):  # sn_external's power iterations first, as fit runs them
            inner = tr._train_step_for(1)

            def step(state, b):
                if tr.sn_external:
                    power_iterations(state.model, 1)
                return inner(state, b)

            return step

        root = os.path.join(case["root"], tag)
        tr, state, seen = trainer_of(conf, root)
        step = step_of(tr)
        mine = shard_batch(batch, tr.mesh)
        state, m1 = step(state, mine)
        names = list(state.opt_state["mu"])
        params = [p.detach() for p in state.named_parameters().values()]
        out[f"mesh_{tag}_resident"] = np.asarray([
            sum(p.numel() for p in params), sum(g.numel() for g in seen["g"]),
            sum(p.grad is not None for p in params)])
        whole = load_model(conf, device="cpu", sn_state=True)
        out[f"mesh_{tag}_expected_resident"] = np.asarray(_expected_resident(whole, tr.mesh))
        out[f"{tag}_whole_elements"] = np.asarray(sum(p.numel() for p in whole.parameters()))
        for k, g in zip(names, tr.optimizer.held_whole(dict(zip(names, seen["g"])))):
            out[f"mesh_{tag}_grad.{k}"] = g.numpy()
        tr.save_checkpoint(state, 0)
        state, m2 = step(state, mine)
        out[f"mesh_{tag}_loss"] = np.asarray([float(m1["loss"]), float(m2["loss"])])
        for k, v in tr.model_tensors(state).items():  # copies: the init below writes in place
            out[f"mesh_{tag}_param.{k}"] = v.numpy().copy()
        # a second seeded init of the held model (its held kernels drawn
        # whole, then chunked), against one of a whole model
        again = tr.model_tensors(tr.init_state(torch.Generator().manual_seed(3), noise_seed=4))
        seed_train_(whole, conf, torch.Generator().manual_seed(3))
        ref = whole.state_dict()
        out[f"mesh_{tag}_reseed_err"] = np.asarray(max(
            float((again[k] - ref[k]).abs().max()) for k in tr.optimizer.held))
        if rank == 0:
            res, rstate, _ = trainer_of(single, root)
            rstate = res.load_checkpoint(rstate)
            rstate, r2 = step_of(res)(rstate, batch)
            out[f"resumed_{tag}_loss"] = np.asarray(float(r2["loss"]))
            for k, v in res.model_tensors(rstate).items():
                out[f"resumed_{tag}_param.{k}"] = v.numpy()
            one, ostate, oseen = trainer_of(single, os.path.join(case["root"], f"one_{tag}"))
            ostep = step_of(one)
            ostate, o1 = ostep(ostate, batch)
            ostate, o2 = ostep(ostate, batch)
            out[f"one_{tag}_loss"] = np.asarray([float(o1["loss"]), float(o2["loss"])])
            for k, g in zip(names, oseen["g"]):
                out[f"one_{tag}_grad.{k}"] = g.numpy()
            for k, v in one.model_tensors(ostate).items():
                out[f"one_{tag}_param.{k}"] = v.numpy()
    return out


def scenario_zero3_frees(rank: int, world: int, args: dict) -> dict:
    """A tiny CrossFormer under ZeRO-3 at data 2 (args['conf'], args['batch'],
    this rank's row): one step, then the model, its optimizer, step and
    state let go with Python's cyclic collector off. 'zero3_held_bytes':
    the parameters' bytes the rank held; 'zero3_alive_bytes': the bytes of
    those still alive after (0 when nothing holds them in a reference
    cycle, which only the collector would free)."""
    import gc
    import weakref

    import torch

    from credit_torch.data.channels import ChannelSchema
    from credit_torch.models import load_model
    from credit_torch.parallel.mesh import build_mesh
    from credit_torch.parallel.sharding import ShardedOptimizer, shard_batch
    from credit_torch.trainers.scheduler import load_scheduler
    from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step

    conf = args["conf"]
    schema = ChannelSchema.from_config(conf)
    batch = {k: _t(v) for k, v in np.load(args["batch"]).items()}
    mesh = build_mesh(2, 1, 1)

    def step_once():
        model = load_model(conf, device="cpu", sn_state=True)
        opt = ShardedOptimizer(make_optimizer(conf, load_scheduler(conf)), mesh,
                               [k for k, _ in model.named_parameters()],
                               [tuple(p.shape) for p in model.parameters()])
        step = make_train_step(model, lambda y, p: torch.mean((p - y) ** 2), opt, schema,
                               device="cpu", mesh=mesh)
        state = TrainState.create(model, opt)
        step(state, shard_batch(batch, mesh))
        held = sum(p.numel() * p.element_size() for p in model.parameters())
        return [weakref.ref(p) for p in model.parameters()], held

    gc.collect()
    gc.disable()
    try:
        refs, held = step_once()
        alive = sum(r().numel() * r().element_size() for r in refs if r() is not None)
    finally:
        gc.enable()
    return {"zero3_held_bytes": np.asarray(held), "zero3_alive_bytes": np.asarray(alive)}


def scenario_many(rank: int, world: int, args: dict) -> dict:
    """Several scenarios in one launch (one start-up of the ranks):
    args['runs'] lists [scenario, its args]; the i-th one's outputs are
    prefixed '<i>:'."""
    out = {}
    for i, (name, a) in enumerate(args["runs"]):
        out.update((f"{i}:{k}", v) for k, v in globals()[f"scenario_{name}"](rank, world, a).items())
    return out


def _record_draws(draws: dict):
    """Wrap the noisy CrossFormer's forward so that every call records the
    latent and the last injection's pixel noise (the whole field's) it
    used, under 'train' or 'valid' by the model's mode."""
    from credit_torch.models import sdl

    fwd = sdl.CrossFormerWithNoise.forward

    def forward(self, x, noise=None, generator=None, capture=None):
        cap = {} if capture is None else capture
        y = fwd(self, x, noise, generator, cap)
        mode = "train" if self.training else "valid"
        draws.setdefault(f"{mode}_latent", []).append(cap["latent"].detach().numpy())
        draws.setdefault(f"{mode}_pixel", []).append(cap["noise_inject3"].detach().numpy())
        return y

    sdl.CrossFormerWithNoise.forward = forward


def scenario_fit(rank: int, world: int, args: dict) -> dict:
    """run_training of args['conf'] through the CREDIT_* variables, then
    run_rollout from its checkpoint (each rank its stride of the init
    times): the written files; with args['draws'], the noisy model's
    draws of each train and validation forward."""
    from credit_torch.applications import run_rollout, run_training

    draws: dict = {}
    if args.get("draws"):
        _record_draws(draws)
    state = run_training(args["conf"], device="cpu")
    out = {"step": np.asarray(state.step), **{k: np.stack(v) for k, v in draws.items()}}
    if args.get("rollout"):
        paths = run_rollout(args["conf"], n_steps=2, device="cpu")
        out["written"] = np.asarray(sorted(os.path.relpath(p, args["conf"]["save_loc"])
                                           for p in paths))
    return out


def scenario_rollout(rank: int, world: int, args: dict) -> dict:
    """make_scan_rollout of the folded tiny CrossFormer on the mesh
    args['mesh'] and unsharded."""
    import torch

    from credit_torch.convert_jax import from_jax_variables
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.models import load_model
    from credit_torch.parallel.mesh import build_mesh
    from credit_torch.rollout import make_scan_rollout

    conf = args["conf"]
    with open(args["variables"], "rb") as f:
        variables = pickle.load(f)
    model = load_model(conf, device="cpu")
    model.load_state_dict(from_jax_variables(variables, conf, device="cpu"))
    schema = ChannelSchema.from_config(conf)
    x0 = _t(np.load(args["batch"])["x"])
    out = {}
    for tag, mesh in (("one", None), ("mesh", build_mesh(*args["mesh"]))):
        run = make_scan_rollout(model, schema, 3, device="cpu", mesh=mesh)
        x, stats = run(x0)
        out[f"{tag}_x"], out[f"{tag}_stats"] = x.numpy(), stats.to(torch.float32).numpy()
    return out


def main() -> int:
    scenario, rank, world, store, out_dir, args = sys.argv[1:7]
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    with open(args) as f:
        args = json.load(f)
    if scenario == "fit":  # through maybe_initialize, as a user launches it
        os.environ.update(CREDIT_COORDINATOR=f"file://{store}", CREDIT_NUM_PROCESSES=str(world),
                          CREDIT_PROCESS_ID=str(rank))
    else:
        _join(rank, world, store)
    out = globals()[f"scenario_{scenario}"](rank, world, args)
    np.savez(os.path.join(out_dir, f"{scenario}_rank{rank}.npz"), **out)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

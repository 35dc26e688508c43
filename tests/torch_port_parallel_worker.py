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
model's draws), `rollout` (make_scan_rollout on a mesh).
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

    from credit_torch.applications.benchmark import benchmark_halo, benchmark_parallelism

    halo = benchmark_halo(h=16, w=12, c=4, k=3, steps=3, device="cpu")
    out["bench_halo_err"] = np.asarray([halo["fwd_err_explicit"], halo["grad_err_explicit"]])
    out["bench_halo_p2p"] = np.asarray(halo["collectives_explicit"].get("p2p", 0))
    rows = benchmark_parallelism(args["bench_conf"], steps=1, warmup=0, device="cpu")
    out["bench_rows"] = np.asarray([[r["dp"], r["tensor"], r["domain"], r["step_ms"],
                                     r["samples_per_s"], r["gridpoints_per_s_per_chip"],
                                     r["loss"], r["scaling_efficiency"]] for r in rows])
    return out


# name -> (x shape, kernel shape (kh, kw, in, out), conv or transpose, stride,
# padding); the slabs are x's rows over 4 ranks
CONV_CASES = {
    "halo_3x3": ((2, 16, 12, 4), (3, 3, 4, 5), "conv", 1, 1),
    "s2d_4x4": ((2, 16, 12, 4), (4, 4, 4, 5), "conv", 2, 1),
    "transpose_k2": ((2, 8, 6, 4), (2, 2, 4, 5), "transpose", 2, 0),
    "transpose_k4": ((2, 8, 6, 4), (4, 4, 4, 5), "transpose", 2, 1),
    "gather_5x5": ((2, 4, 12, 4), (5, 5, 4, 5), "conv", 1, 2),
    "gather_s2_8x8": ((2, 8, 12, 4), (8, 8, 4, 5), "conv", 2, 3),
}


def _tiny(args: dict):
    """The tiny CrossFormer config, its port model with the given numpy
    variables (credit_tpu's tree), the seeded batch."""
    from credit_torch.convert_jax import from_jax_variables
    from credit_torch.models import load_model

    conf = args["conf"]
    with open(args["variables"], "rb") as f:
        variables = pickle.load(f)
    model = load_model(conf, device="cpu", sn_state=True)
    model.load_state_dict(from_jax_variables(variables, conf, device="cpu", fold=False))
    batch = np.load(args["batch"])
    return conf, model, {k: _t(batch[k]) for k in batch.files}


def scenario_train(rank: int, world: int, args: dict) -> dict:
    """The unsharded step, then the same step on each mesh of
    args['meshes'] ((dp, tp, domain) lists), from the same weights: the
    loss, the (reduced, whole) gradients the optimizer was given and the
    updated parameters, each prefixed 'one_' or 'mesh<dp><tp><domain>_'."""
    import torch

    from credit_torch.data.channels import ChannelSchema
    from credit_torch.parallel import distributed as D
    from credit_torch.parallel.mesh import build_mesh
    from credit_torch.parallel.sharding import ShardedOptimizer, shard_batch
    from credit_torch.trainers.scheduler import load_scheduler
    from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step

    conf, model, batch = _tiny(args)
    schema = ChannelSchema.from_config(conf)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}

    def mse(y, p):
        return torch.mean((p - y) ** 2)

    runs = [("one", None)] + [("mesh" + "".join(map(str, d)), build_mesh(*d))
                              for d in args["meshes"]]
    for tag, mesh in runs:
        model.load_state_dict(start)
        opt = make_optimizer(conf, load_scheduler(conf))
        names = [k for k, _ in model.named_parameters()]
        if mesh is not None:
            opt = ShardedOptimizer(opt, mesh, names, [tuple(p.shape) for p in model.parameters()])
        seen = {}
        inner_update = opt.update

        def update(grads, st, params, inner_update=inner_update, seen=seen):
            seen["g"] = [g.clone() for g in grads]
            return inner_update(grads, st, params)

        opt.update = update
        step = make_train_step(model, mse, opt, schema, device="cpu", mesh=mesh)
        state = TrainState.create(model, opt)
        b = batch if mesh is None else shard_batch(batch, mesh)
        D.COUNTS.clear()
        state, metrics = step(state, b)
        out[f"{tag}_loss"] = metrics["loss"].numpy()
        for k, g in zip(names, seen["g"]):
            out[f"{tag}_grad.{k}"] = g.numpy()
        for k, p in model.named_parameters():
            out[f"{tag}_param.{k}"] = p.detach().numpy()
        out[f"{tag}_collectives"] = np.asarray(sum(D.COUNTS.values()))
        out[f"{tag}_mu_chunks"] = np.asarray(sum(v.numel() for v in state.opt_state["mu"].values()))
    out["mu_whole"] = np.asarray(sum(p.numel() for p in model.parameters()))
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

"""Parallelism micro-benchmarks: port of credit_tpu/applications/benchmark.py.

Both run on every rank of an initialized process group (one GPU a rank;
`parallel.distributed.maybe_initialize`) and return the same on each.

`benchmark_halo` holds the explicit latitude halo exchange (a
size-preserving conv on each rank's slab, kernel 2 on the halo-extended
rows) against the unsharded stencil, forward and gradient, counts the
port's collectives a step and times both. credit_tpu times GSPMD's halos
beside its explicit ring; the port has only the explicit exchange.

`benchmark_parallelism` runs the train step under each (dp, tp, domain)
mesh that fills the group and reports a row per mesh with the reference's
keys: step_ms, samples_per_s, gridpoints_per_s_per_chip, peak memory and
the loss (reference: applications/benchmark_parallelism.py:1-15,159).
Several ranks that share one card give no throughput figure.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence, Tuple

import torch

from credit_torch import resolve_device

logger = logging.getLogger(__name__)


def _timer(dev: torch.device):
    """(mark, ms between marks): CUDA events on a card, the host clock
    on the CPU."""
    if dev.type == "cuda":
        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def span(a, b):
            b.synchronize()
            return a.elapsed_time(b)
    else:
        def mark():
            return time.perf_counter()

        def span(a, b):
            return (b - a) * 1e3
    return mark, span


def benchmark_halo(h: int = 128, w: int = 256, c: int = 64, k: int = 3, steps: int = 20,
                   dtype=torch.float32, device="cuda") -> dict:
    """`steps` size-preserving k x k convs in a row on a (1, h, w, c) field,
    unsharded and lat-sharded over every rank of the group (a (1, 1, n)
    mesh): the largest forward and gradient (of sum(y^2) in x) errors of
    the slabs gathered against the unsharded stencil, the collectives a
    step by kind, and the ms a step of each (the unsharded one on each
    rank alone)."""
    from credit_torch.ops import conv as conv_ops
    from credit_torch.parallel import context as par_ctx
    from credit_torch.parallel import distributed as D
    from credit_torch.parallel.halo import gather_lat, shard_lat
    from credit_torch.parallel.mesh import build_mesh

    dev = resolve_device(device)
    n = D.world_size()
    mesh = build_mesh(1, 1, n)
    group, r = mesh.group("domain"), mesh.coord("domain")
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((1, h, w, c), generator=g).to(dev, dtype)
    kern = (torch.randn((k, k, c, c), generator=g) * 0.05 / c ** 0.5).to(dev, dtype)
    pad = (k - 1) // 2

    def loop(z):
        for _ in range(steps):
            z = conv_ops.conv2d(z, kern, None, 1, pad)
        return z

    def sharded(z):
        with par_ctx.explicit_halo(mesh), par_ctx.lat_slabs():
            return loop(z)

    xr = x.clone().requires_grad_(True)
    ref = loop(xr)
    (ref.float() ** 2).sum().backward()
    xs = shard_lat(x, n, r).clone().requires_grad_(True)
    D.COUNTS.clear()
    ys = sharded(xs)
    (ys.float() ** 2).sum().backward()
    counts = {kind: v / steps for kind, v in D.COUNTS.items()}
    y_all = gather_lat(ys.detach(), group)
    g_all = gather_lat(xs.grad, group)
    scale = ref.detach().float().abs().max().item()
    gscale = xr.grad.float().abs().max().item()
    out = {"n_devices": n, "shape": [h, w, c], "kernel": k, "steps": steps,
           "dtype": str(dtype).replace("torch.", ""),
           "fwd_err_explicit": (y_all.float() - ref.detach().float()).abs().max().item() / scale,
           "grad_err_explicit": (g_all.float() - xr.grad.float()).abs().max().item() / gscale,
           "collectives_explicit": counts}
    mark, span = _timer(dev)
    with torch.no_grad():
        for name, fn, arg in (("unsharded", loop, x), ("explicit", sharded, xs.detach())):
            fn(arg)
            D.barrier()
            a = mark()
            fn(arg)
            out[f"ms_per_step_{name}"] = span(a, mark()) / steps
    t = torch.tensor([out["ms_per_step_explicit"]], device=dev)
    out["ms_per_step_explicit_max_rank"] = float(D.all_reduce(t, op=torch.distributed.ReduceOp.MAX))
    logger.info("halo bench %s", out)
    return out


def default_combos(world: int) -> List[Tuple[int, int, int]]:
    """The (dp, tp, domain) meshes of the reference's list whose size is
    the group's."""
    combos = [(1, 1, 1), (2, 1, 1), (1, 1, 2), (4, 1, 1), (2, 1, 2), (2, 2, 1), (1, 2, 2),
              (1, 1, 4), (8, 1, 1), (2, 2, 2), (4, 1, 2)]
    return [c for c in combos if c[0] * c[1] * c[2] == world]


def benchmark_parallelism(conf: dict, combos: Optional[Sequence[Tuple[int, int, int]]] = None,
                          steps: int = 5, warmup: int = 2, device="cuda") -> List[dict]:
    """The train step (MSE, the config's AdamW) of `conf`'s model, seeded
    weights, under each mesh of `combos` (default: `default_combos`), at a
    global batch of dp samples: a row per mesh with the slowest rank's
    step_ms (CUDA events on a card), samples_per_s, gridpoints_per_s_per_chip,
    the peak device memory in GiB, the parameter and gradient GiB a rank
    holds (ZeRO-3's chunks at dp > 1; each the largest rank's), the
    parameters each tp rank computes a share of (`tp_split_params`: the
    attention blocks' and, where the hidden width divides, the FF blocks'
    slices; 0 at tp 1) and the last loss, then each row's
    scaling_efficiency against the first."""
    from credit_torch.convert_jax import seed_train_
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.models import load_model
    from credit_torch.parallel import distributed as D
    from credit_torch.parallel.mesh import build_mesh
    from credit_torch.parallel.sharding import ShardedOptimizer
    from credit_torch.trainers.scheduler import load_scheduler
    from credit_torch.trainers.trainer import (TrainState, make_optimizer, make_train_step,
                                               tp_partial_names)

    dev = resolve_device(device)
    world = D.world_size()
    combos = list(combos or default_combos(world))
    schema = ChannelSchema.from_config(conf)
    h, w = int(conf["model"]["image_height"]), int(conf["model"]["image_width"])
    mark, span = _timer(dev)
    rows = []
    for dp, tp, dom in combos:
        if dp * tp * dom != world:
            raise ValueError(f"mesh {dp}x{tp}x{dom} does not fill the {world} ranks")
        mesh = build_mesh(dp, tp, dom) if D.initialized() else None
        model = load_model(conf, device=dev, sn_state=True)
        seed_train_(model, conf, torch.Generator().manual_seed(0))
        opt = make_optimizer(conf, load_scheduler(conf))
        if mesh is not None:
            opt = ShardedOptimizer(opt, mesh, [k for k, _ in model.named_parameters()],
                                   [tuple(p.shape) for p in model.parameters()])
        row_b = 1
        g = torch.Generator().manual_seed(1 + (mesh.coord("dp") if mesh is not None else 0))
        batch = {"x": torch.randn((row_b, 1, h, w, schema.n_input), generator=g),
                 "y": torch.randn((row_b, 1, h, w, schema.n_target), generator=g)}
        batch = {k: v.to(dev) for k, v in batch.items()}

        def mse(y, p):
            return torch.mean((p.float() - y) ** 2)

        step = make_train_step(model, mse, opt, schema, device=dev, mesh=mesh)
        state = TrainState.create(model, opt)
        seen, inner = {}, opt.update

        def update(grads, st, params, inner=inner, seen=seen):  # the gradients as held
            seen["bytes"] = sum(g.numel() * g.element_size() for g in grads)
            return inner(grads, st, params)

        opt.update = update
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(warmup):
            state, m = step(state, batch)
        D.barrier()
        a = mark()
        for _ in range(steps):
            state, m = step(state, batch)
        ms = span(a, mark()) / steps
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
        held = [sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30,
                seen["bytes"] / 2**30]
        if D.world_size() > 1:
            t = D.all_reduce(torch.tensor([ms, peak, *held], device=dev),
                             op=torch.distributed.ReduceOp.MAX)
            ms, peak, held = float(t[0]), float(t[1]), [float(t[2]), float(t[3])]
        b = dp * row_b
        rows.append({"dp": dp, "tensor": tp, "domain": dom, "step_ms": ms,
                     "samples_per_s": b / ms * 1e3,
                     "gridpoints_per_s_per_chip": b * h * w / (ms * 1e-3) / (dp * tp * dom),
                     "peak_mem_gb": peak, "param_gb": held[0], "grad_gb": held[1],
                     "tp_split_params": len(tp_partial_names(model, tp)) if tp > 1 else 0,
                     "loss": float(m["loss"])})
        logger.info("bench %s", rows[-1])
        del state, model, opt, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if rows:
        base = rows[0]["gridpoints_per_s_per_chip"] or 1.0
        for r in rows:
            r["scaling_efficiency"] = r["gridpoints_per_s_per_chip"] / base
    return rows

"""Multi-step truncated-BPTT training: port of credit_tpu/trainers/trainer.py
(`TrainState`, `make_optimizer`, `make_train_step`, `make_eval_step`,
`Trainer` with `fit`, `load_trainer`).

Per optimizer step, for rollout steps s = 0..forecast_len-1:

    y_pred_s = postblocks(model(x_s))  (train mode: one SN power iteration)
    if s in backprop_on_timestep: backward of loss_s, gradients summed
    x_{s+1} = update_x(x_s, y_pred_s, forcing_s), detached

then the summed gradients and losses are divided by the number of
backpropagated steps, the NaN guard zeroes the gradients of a non-finite
loss (the AdamW moments still advance; the parameters stay), AdamW with
optax's formulas updates the parameters, and the EMA follows with decay
min(decay, (1+n)/(10+n)). The reference's one jitted program becomes eager
PyTorch on the model's own parameters and u/v buffers, updated in place.
Batches come in physical units when a Normalizer is given and are
normalized on their device inside the step, in f32.

Ensembles (`trainer.ensemble_size` E > 1) repeat each sample E times in a
row (jnp.repeat), so the model sees (B*E, ...) and the loss the (B, E, ...)
members; metrics and the next step's input take the member mean. A model
with noise (`crossformer-ensemble`) draws it from the state's generator,
which the checkpoint keeps. `grad_accum_every` k wraps AdamW as
optax.MultiSteps does: the micro-gradients are averaged, and clipping,
AdamW and its schedule count run on every k-th call only. With
`sn_external` the u/v power iterations run before the step
(`Trainer.fit`), and the step's forwards divide by sigma from the frozen
vectors.

`Trainer.fit` runs epochs of sampled init times through that step, with
batches assembled and pinned on a producer thread, validation on the EMA
weights, latitude-weighted per-variable metrics kept on the device and
fetched once an epoch, `training_log.csv`, checkpoints and early stopping.

Preblocks (`conf["preblocks"]`, `preblock.build_preblocks`) run where the
reference runs them: the 'ic_only' phase once on the normalized initial
state, the 'per_step' phase on x at the top of every rollout step, before
the ensemble repeat.

Stateful postblocks (SKEBS) get fresh states for the B x E members at
every step and draw from the step's generator; a trainable block's net
(the learned backscatter rate) is part of the state (`TrainState.nets`,
its parameters named `_postblocks.<i>.<name>`), updated with the model by
the optimizer, the clip, MultiSteps and the EMA, kept in the checkpoint;
validation runs the EMA's copy of it.

`trainer.parallelism: {data, tensor, domain, halo}` runs the step on a
(dp, tp, domain) mesh of processes, one GPU each (parallel/): each dp
coordinate samples its own rows of the batch, tp and domain peers the same
rows; the forward runs under `parallel.context.explicit_halo(mesh)`, where
the CrossFormer family and the SwinV2 family (fuxi, swin, wrf, dscale)
split latitude over the domain ranks, the attention blocks split heads
over the tp ranks and the FF blocks their hidden layers (other models
compute the whole field on every domain rank, and those with neither
block the whole model on every tp rank, which the trainer logs once);
with dp > 1 the model's large
parameters are held as dp chunks and gathered block by block (ZeRO-3,
`parallel.sharding.ParamShards`, applied by `TrainState.create`); the
gradients are summed over the ranks that computed shares of them
(`parallel.sharding.reduce_gradients`), the NaN guard reads the mean loss
over the group, the AdamW moments and the EMA are sharded by
`param_spec` (`ShardedOptimizer`) and updated chunk to chunk, the metrics
are averaged over the group, and only the primary process writes the
schema, the log and checkpoints, which hold whole tensors (a run resumes
at any world size). credit_tpu's
`halo: gspmd` is accepted and runs the explicit exchange: the port has no
GSPMD. `flatten_optimizer` with data > 1 is refused as in credit_tpu.

The TPU levers `flatten_optimizer`, `scan_blocks` and `remat` are accepted
and ignored. The `era5-diffusion` trainer swaps in its own steps
(trainers/diffusion.py).
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import logging
import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from credit_torch import registry, resolve_device
from credit_torch.data.channels import ChannelSchema
from credit_torch.models.layers import freeze_sn_updates
from credit_torch.models.spectral_utils import power_iter_model_
from credit_torch.parallel import context as par_ctx
from credit_torch.parallel import distributed as dist_ops
from credit_torch.parallel.mesh import data_parallel_coords
from credit_torch.parallel.sharding import param_shards
from credit_torch.postblock.stochastic import (apply_postblocks_stateful,
                                               init_postblock_params, init_postblock_states,
                                               postblock_nets, split_postblock_params)
from credit_torch.preblock import apply_preblocks, build_preblocks
from credit_torch.trainers.scheduler import Schedule

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    """step: train steps taken (micro-steps under grad_accum_every); model:
    holds the parameters and the spectral u/v buffers; opt_state: the
    optimizer's (`AdamW.init` / `MultiSteps.init`); ema_params: name -> EMA
    of each parameter, or None (EMA off); noise: the generator of the train
    step's draws (a noisy model's, then the stateful postblocks'), on the
    model's device, or None (torch's default generator); nets: the
    trainable postblocks' nets keyed by their index in the pipeline
    (`postblock.stochastic.postblock_nets`), or None."""

    step: int
    model: torch.nn.Module
    opt_state: dict
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    noise: Optional[torch.Generator] = None
    nets: Optional[torch.nn.ModuleDict] = None

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: "AdamW", ema: bool = False,
               noise_seed: int = 0, nets: Optional[torch.nn.ModuleDict] = None,
               noise_keys: Sequence[int] = ()) -> "TrainState":
        """`noise_keys` are folded into the noise generator's seed (the dp
        coordinate under a mesh: `Trainer.noise_keys`). A sharded optimizer
        first applies ZeRO-3 to the model (at dp > 1), so that the state
        holds the parameters' chunks."""
        shard = getattr(optimizer, "shard_parameters", None)
        if shard is not None:
            shard(model)
        params = train_parameters(model, nets)
        # a sharded optimizer keeps this rank's chunk of each EMA tensor
        chunk = getattr(optimizer, "chunk", lambda k, p: p.detach().clone())
        ema_params = {k: chunk(k, p.detach()) for k, p in params.items()} if ema else None
        dev = next(model.parameters()).device
        noise = torch.Generator(device=dev).manual_seed(
            _derived_seed(noise_seed, 0x401E, *noise_keys))
        return cls(0, model, optimizer.init(params), ema_params, noise, nets)

    def named_parameters(self) -> Dict[str, torch.nn.Parameter]:
        return train_parameters(self.model, self.nets)


def train_parameters(model: torch.nn.Module, nets: Optional[torch.nn.ModuleDict] = None
                     ) -> Dict[str, torch.nn.Parameter]:
    """The trained parameters by name: the model's, then each postblock
    net's as `_postblocks.<i>.<name>` (credit_tpu's params['_postblocks'])."""
    params = dict(model.named_parameters())
    if nets is not None:
        params.update((f"_postblocks.{k}", p) for k, p in nets.named_parameters())
    return params


def _net_tensors(nets: Optional[torch.nn.ModuleDict]):
    """{str(i): {name: parameter}} of the state's postblock nets."""
    return None if nets is None else {k: dict(m.named_parameters()) for k, m in nets.items()}


def _derived_seed(*keys: int) -> int:
    """A generator seed from integer keys (numpy's SeedSequence), so that
    streams seeded from one config seed do not coincide."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1)[0])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))).float())


class AdamW:
    """optax.chain([clip_by_global_norm(clip)], adamw(schedule, b1, b2,
    eps=1e-8, eps_root=0, weight_decay)) in PyTorch: moments with bias
    correction at the 1-based count, decoupled decay applied to every leaf,
    the learning rate read from `schedule` at the 0-based count. `norm_fn`
    takes the gradients' global norm for the clip (the sharded optimizer's
    sums its chunks over the ranks)."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip: float = 0.0):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.clip = weight_decay, clip
        self.norm_fn = global_norm

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        zeros = lambda: {k: torch.zeros_like(p, memory_format=torch.preserve_format)  # noqa: E731
                         for k, p in params.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def update(self, grads: List[torch.Tensor], state: dict, params: List[torch.Tensor]):
        """(updates, new state) for gradients and parameters listed in the
        order of the state's keys. The moments are updated in place."""
        grads = list(grads)
        if self.clip > 0:
            gnorm = self.norm_fn(grads)
            if not bool(gnorm < self.clip):
                grads = [g / gnorm * self.clip for g in grads]
        mu, nu = list(state["mu"].values()), list(state["nu"].values())
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        count = state["count"] + 1
        den = torch._foreach_div(nu, 1 - self.b2 ** count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, 1 - self.b1 ** count)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -float(self.schedule(state["count"])))
        return upd, {**state, "count": count}


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=every) with its default
    use_grad_mean: each call folds its gradients into a running mean (acc
    + (g - acc) / (n + 1)); the every-th call runs the inner chain (clip,
    AdamW, its schedule count) on the mean, returns its updates and
    restarts the mean; the other calls return None and leave the inner
    state as it was. The state is the inner one plus `mini_step` and the
    mean `acc`."""

    def __init__(self, inner: AdamW, every: int):
        self.inner, self.every = inner, every

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        state = self.inner.init(params)
        state["acc"] = {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                        for k, p in params.items()}
        state["mini_step"] = 0
        return state

    def update(self, grads: List[torch.Tensor], state: dict, params: List[torch.Tensor]):
        """(updates or None, new state), grads and params in the order of
        the state's keys; the mean is updated in place."""
        n = state["mini_step"]
        acc = list(state["acc"].values())
        delta = torch._foreach_sub(list(grads), acc)
        torch._foreach_div_(delta, float(n + 1))
        torch._foreach_add_(acc, delta)
        if n + 1 < self.every:
            return None, {**state, "mini_step": n + 1}
        updates, new = self.inner.update(acc, state, params)
        torch._foreach_zero_(acc)
        return updates, {**new, "mini_step": 0}


def make_optimizer(conf: dict, schedule: Schedule):
    """AdamW betas (0.9, 0.95) with the trainer section's `weight_decay`
    and, where `grad_max_norm` > 0, global-norm clipping first; wrapped in
    MultiSteps where `grad_accum_every` > 1."""
    t = conf.get("trainer", {})
    opt = AdamW(schedule, weight_decay=float(t.get("weight_decay", 0.0)),
                clip=float(t.get("grad_max_norm", 0.0) or 0.0))
    accum = int(t.get("grad_accum_every", 1))
    return MultiSteps(opt, accum) if accum > 1 else opt


def _ema_decay(base: float, n: int) -> float:
    return min(base, (1.0 + n) / (10.0 + n))




def _members(y_pred: torch.Tensor, b: int, ensemble_size: int) -> torch.Tensor:
    """(B*E, ...) predictions as (B, E, ...): sample-major, the layout of
    repeat_interleave (jnp.repeat) over the batch."""
    return y_pred.reshape(b, ensemble_size, *y_pred.shape[1:])


def _prepare(batch: Dict[str, torch.Tensor], dev, normalizer, schema: ChannelSchema):
    """The batch on `dev` in f32, normalized there when a Normalizer is
    given (credit_tpu's in-step normalization)."""
    out = {k: v.to(dev).float() for k, v in batch.items() if v is not None}
    if normalizer is not None:
        out["x"] = normalizer.normalize_input(out["x"])
        out["y"] = normalizer.normalize_target(out["y"])
        if "forcing" in out:
            out["forcing"] = normalizer.normalize_forcing(out["forcing"], schema)
    return out


def _next_input(schema, x, y_pred, forcing, s: int, history_len: int):
    """The next step's input (no gradient): forcing frame s is valid at
    t0+1+s, the next state's time."""
    f_next = None if forcing is None else forcing[:, s:s + 1]
    new = schema.update_x(x[:, -1:], y_pred[:, -1:], f_next)
    return torch.cat([x[:, 1:], new], dim=1) if history_len > 1 else new


def tp_partial_names(model: torch.nn.Module, tp: int) -> List[str]:
    """The parameters whose gradient each of `tp` ranks holds a share of:
    those of the attention blocks (their heads split over the ranks) and,
    where the hidden width divides by tp, of the FF blocks' slices of the
    hidden layer: fc1's kernel and bias, fc2's kernel and the pre-norm
    FF's input LN (each rank's LN output feeds only its slice). fc2's bias
    and the post-norm LN (SwinV2) are computed whole on every rank."""
    from credit_torch.models.layers import FeedForward, WindowAttention
    from credit_torch.models.swin import SwinBlockV2

    names = []
    for m, mod in model.named_modules():
        if isinstance(mod, WindowAttention):
            own = [p for p, _ in mod.named_parameters()]
        elif isinstance(mod, FeedForward) and mod.fc1.kernel.shape[1] % tp == 0:
            own = ["norm.scale", "norm.bias", "fc1.kernel", "fc1.bias", "fc2.kernel"]
        elif isinstance(mod, SwinBlockV2) and mod.mlp_fc1.kernel.shape[1] % tp == 0:
            own = ["mlp_fc1.kernel", "mlp_fc1.bias", "mlp_fc2.kernel"]
        else:
            continue
        names += [f"{m}.{p}" if m else p for p in own]
    return names


class _Parallel:
    """What a step needs of the mesh: the mesh, each trained tensor's
    gradient divisor (parallel.sharding.gradient_divisors) and whether the
    model holds it as a ZeRO-3 chunk, in the order of `names`; the
    optimizer (a ShardedOptimizer)."""

    def __init__(self, mesh, model, names: Sequence[str], optimizer):
        from credit_torch.parallel.sharding import gradient_divisors

        self.mesh, self.optimizer = mesh, optimizer
        lat = bool(getattr(model, "lat_sharded", False)) and mesh.shape["domain"] > 1
        # the postblock nets run on the whole prediction on every domain rank
        whole = [k for k in names if k.startswith("_postblocks.")]
        self.divisors = gradient_divisors(names, mesh, lat,
                                          tp_partial_names(model, mesh.shape["tp"]),
                                          whole)
        held = getattr(optimizer, "held", set())
        self.held = [k in held for k in names]

    def reduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        from credit_torch.parallel.sharding import reduce_gradients

        return reduce_gradients(grads, self.divisors, self.held, self.mesh.peers())

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The reduced gradients' global norm, each element counted once."""
        if any(self.held):
            return self.optimizer.norm(grads)
        return global_norm(grads)


def power_iterations(model: torch.nn.Module, n_iter: int) -> None:
    """trainer.sn_external's u/v power iterations; under ZeRO-3 on each
    block's gathered kernels, one block at a time."""
    shards = param_shards(model)
    if shards is None:
        power_iter_model_(model, n_iter)
    else:
        shards.each_block(lambda m: power_iter_model_(m, n_iter))


def _global_loss(loss: torch.Tensor, par: Optional[_Parallel]) -> torch.Tensor:
    """The loss averaged over the process group (tp and domain peers hold
    the same value, dp rows their own)."""
    if par is None:
        return loss
    return dist_ops.all_reduce(loss.detach()) / dist_ops.world_size()


def make_train_step(model, loss_fn: Callable, optimizer: AdamW, schema: ChannelSchema,
                    forecast_len: int = 1, backprop_on_timestep: Optional[Sequence[int]] = None,
                    history_len: int = 1, ema_decay: float = 0.0, ensemble_size: int = 1,
                    normalizer=None, preblocks=(), preblocks_ic=(), postblocks=(),
                    metrics_fn=None, return_final_state: bool = False,
                    sn_external: bool = False, device="cuda", mesh=None):
    """The multi-step train step, `train_step(state, batch) -> (state,
    metrics)` with state.model being `model`. batch: {'x': (B, T_hist, H, W,
    C_in), 'y': (B, S, H, W, C_t), 'forcing': (B, S, H, W, n_dyn) or absent},
    in physical units when a `normalizer` is given (normalized on the
    device inside the step), else normalized. Stateless `postblocks` act on
    each member's prediction before its loss. With ensemble_size E > 1 the
    loss takes the (B, E, ...) members (a CRPS-family loss) and the rest
    of the step their mean; a noisy model draws from state.noise. With
    `sn_external` the forwards leave u/v as they are (the caller iterates
    them first). metrics: 'loss' and 'grad_norm' (0-d tensors), 'finite'
    (1.0 or 0.0); with `metrics_fn` (a LatWeightedMetrics) its per-variable
    metrics of each rollout step, averaged over forecast_len, as 0-d
    tensors; with `return_final_state`, '_final_x', the predicted input
    state one step past the batch, in physical units (replay training
    stores it). The step updates the model in place (under MultiSteps only
    on every k-th call) and reads the device twice: the loss's finiteness
    and, with clipping, the gradient norm against the clip. With a `mesh`
    (parallel.mesh.Mesh) the batch is this rank's dp rows, the forwards run
    under explicit_halo(mesh), the gradients are reduced over the group,
    the loss (for the NaN guard too) and the metrics are the group's means,
    and `optimizer` is the ShardedOptimizer (its EMA chunks follow the
    parameters' chunks). `preblocks_ic`
    run once on the normalized initial state, `preblocks` on x at the top
    of every rollout step. Stateful postblocks start from fresh states for
    the B x E members at every call, carry them across the rollout steps
    and draw from state.noise after the model; a trainable block runs the
    state's net (`state.nets`), whose parameters the step updates with the
    model's."""
    dev = resolve_device(device)
    bp = set(backprop_on_timestep or range(forecast_len))
    n_bp = max(len(bp), 1)
    stochastic = getattr(model, "stochastic", False)
    has_stateful = any(getattr(b, "is_stateful", False) for b in postblocks)
    has_trainable = any(getattr(b, "is_trainable", False) for b in postblocks)

    def forward(mdl, x, gen, pb_states, nets):
        with freeze_sn_updates(sn_external):
            y_pred = mdl(x, generator=gen) if stochastic else mdl(x)
        if has_stateful:
            return apply_postblocks_stateful(postblocks, y_pred, x, pb_states, gen, nets)
        for b in postblocks:
            y_pred = b(y_pred, x)
        return y_pred, pb_states

    par = None

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        nonlocal par
        if mesh is not None and par is None:
            par = _Parallel(mesh, model, list(state.opt_state["mu"]), optimizer)
        with par_ctx.explicit_halo(mesh):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        mdl = state.model
        mdl.train()
        if has_trainable and state.nets is None:
            raise ValueError("trainable postblocks need the state's nets: TrainState.create(..., "
                             "nets=postblock_nets(postblocks))")
        params = state.named_parameters()
        nets = _net_tensors(state.nets)
        for p in params.values():
            p.grad = None
        batch = _prepare(batch, dev, normalizer, schema)
        x = apply_preblocks(preblocks_ic, batch["x"])
        b = x.shape[0]
        pb_states = (init_postblock_states(postblocks, b * ensemble_size, dev)
                     if has_stateful else {})
        total = torch.zeros((), device=dev)
        mvals = None
        for s in range(forecast_len):
            y_t = batch["y"][:, s:s + 1]
            x = apply_preblocks(preblocks, x)
            x_in = torch.repeat_interleave(x, ensemble_size, dim=0) if ensemble_size > 1 else x
            if s in bp:
                y_pred, pb_states = forward(mdl, x_in, state.noise, pb_states, nets)
                if ensemble_size > 1:
                    y_e = _members(y_pred, b, ensemble_size)
                    loss = loss_fn(y_t, y_e)
                    y_pred = y_e.mean(dim=1)
                else:
                    loss = loss_fn(y_t, y_pred)
                loss.backward()  # sums into .grad across the backpropagated steps
                total = total + loss.detach()
            else:
                with torch.no_grad():
                    y_pred, pb_states = forward(mdl, x_in, state.noise, pb_states, nets)
                    if ensemble_size > 1:
                        y_pred = _members(y_pred, b, ensemble_size).mean(dim=1)
            if metrics_fn is not None:
                with torch.no_grad():
                    v = metrics_fn.values(y_t, y_pred.detach()) / forecast_len
                mvals = v if mvals is None else mvals + v
            if s + 1 < forecast_len:
                with torch.no_grad():  # the reference's stop_gradient
                    x = _next_input(schema, x, y_pred, batch.get("forcing"), s, history_len)
        names = list(state.opt_state["mu"])
        plist = [params[k] for k in names]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in plist]
        if par is not None:
            grads = par.reduce(grads)
            if mvals is not None:
                mvals = _global_loss(mvals, par)
        torch._foreach_div_(grads, float(n_bp))
        # the NaN guard reads the group's loss: every rank skips the same steps
        mean_loss = _global_loss(total / n_bp, par)
        finite = bool(torch.isfinite(mean_loss))
        with torch.no_grad():
            if not finite:  # NaN guard: zero grads, moments advance, params stay
                for g in grads:
                    g.zero_()
            updates, opt_state = optimizer.update(grads, state.opt_state, plist)
            if finite and updates is not None:
                torch._foreach_add_(plist, updates)
            ema = state.ema_params
            if ema is not None:
                d = _ema_decay(ema_decay, state.step)
                evals = [ema[k] for k in names]
                view = getattr(optimizer, "view", None)
                cur = plist if view is None else [view(k, p) for k, p in zip(names, plist)]
                torch._foreach_mul_(evals, d)
                torch._foreach_add_(evals, cur, alpha=1.0 - d)
            gnorm = global_norm(grads) if par is None else par.norm(grads)
        for p in plist:
            p.grad = None
        new_state = TrainState(state.step + 1, mdl, opt_state, ema, state.noise, state.nets)
        metrics = {"loss": mean_loss, "grad_norm": gnorm, "finite": float(finite)}
        if mvals is not None:
            metrics.update(metrics_fn.named(mvals))
        if return_final_state:
            with torch.no_grad():
                final = schema.update_x(x[:, -1:], y_pred[:, -1:], None)
                if normalizer is not None:
                    final = normalizer.denormalize_input(final)
            metrics["_final_x"] = final
        return new_state, metrics

    return train_step


def make_eval_step(model, loss_fn: Callable, schema: ChannelSchema, forecast_len: int = 1,
                   history_len: int = 1, normalizer=None, ensemble_size: int = 1,
                   metrics_fn=None, preblocks=(), preblocks_ic=(), postblocks=(),
                   device="cuda", mesh=None, unshard=None):
    """Validation step scoring the same pipeline the train step runs
    (normalizer, per-step postblocks, the rollout), `eval_step(state,
    batch, generator=None) -> metrics` ('loss' and metrics_fn's, 0-d
    tensors, averaged over forecast_len). The model runs in eval mode, so
    spectral norm reads its u/v without advancing them, and on the EMA
    weights where the state has them, through torch.func.functional_call
    (the model's own parameters are not touched). With ensemble_size E > 1
    the loss scores the (B, E, ...) members and the metrics and rollout
    their mean. `generator` is the noise source of a noisy model, on its
    device, and of the stateful postblocks after it. Preblocks and stateful
    postblocks run as in the train step; a trainable block runs the EMA's
    copy of its net where the state keeps an EMA. With a `mesh` the
    forwards run under explicit_halo(mesh) and the metrics are the group's
    means; `unshard` (the ShardedOptimizer's) gathers the EMA's chunks into
    the form the model holds its parameters in (ZeRO-3's dp chunks, swapped
    in for them and gathered block by block like them)."""
    dev = resolve_device(device)
    stochastic = getattr(model, "stochastic", False)
    has_stateful = any(getattr(b, "is_stateful", False) for b in postblocks)

    def eval_step(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        with par_ctx.explicit_halo(mesh):
            out = _eval_step(state, batch, generator)
        if mesh is not None:
            from credit_torch.parallel.sharding import all_reduce_mean

            out = all_reduce_mean(out)
        return out

    def _eval_step(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        mdl = state.model
        mdl.eval()
        tensors, nets = None, _net_tensors(state.nets)
        if state.ema_params is not None:
            ema = state.ema_params
            if unshard is not None:
                ema = dict(zip(ema, unshard(ema)))
            tensors = {**{k: v for k, v in ema.items()
                          if not k.startswith("_postblocks.")}, **dict(mdl.named_buffers())}
            nets = split_postblock_params(ema) or nets

        kw = {"generator": generator} if stochastic else {}

        def forward(x, pb_states):
            y_pred = (mdl(x, **kw) if tensors is None
                      else torch.func.functional_call(mdl, tensors, (x,), kw))
            if has_stateful:
                return apply_postblocks_stateful(postblocks, y_pred, x, pb_states, generator, nets)
            for b in postblocks:
                y_pred = b(y_pred, x)
            return y_pred, pb_states

        with torch.no_grad():
            batch = _prepare(batch, dev, normalizer, schema)
            x = apply_preblocks(preblocks_ic, batch["x"])
            b = x.shape[0]
            pb_states = (init_postblock_states(postblocks, b * ensemble_size, dev)
                         if has_stateful else {})
            total = torch.zeros((), device=dev)
            mvals = None
            for s in range(forecast_len):
                y_t = batch["y"][:, s:s + 1]
                x = apply_preblocks(preblocks, x)
                if ensemble_size > 1:
                    y_e, pb_states = forward(torch.repeat_interleave(x, ensemble_size, dim=0),
                                             pb_states)
                    y_e = _members(y_e, b, ensemble_size)
                    total = total + loss_fn(y_t, y_e)
                    y_pred = y_e.mean(dim=1)
                else:
                    y_pred, pb_states = forward(x, pb_states)
                    total = total + loss_fn(y_t, y_pred)
                if metrics_fn is not None:
                    v = metrics_fn.values(y_t, y_pred) / forecast_len
                    mvals = v if mvals is None else mvals + v
                if s + 1 < forecast_len:
                    x = _next_input(schema, x, y_pred, batch.get("forcing"), s, history_len)
        out = {"loss": total / forecast_len}
        if mvals is not None:
            out.update(metrics_fn.named(mvals))
        return out

    return eval_step


def _mark(dev: torch.device):
    """A point in the device's stream order (a CUDA event) or, on the
    CPU, the host clock."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _span_ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3


def _accumulate(acc: Optional[dict], metrics: dict) -> dict:
    """acc + metrics, key by key, on the device: the tensors in one foreach
    add, no host read."""
    if acc is None:
        keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
        acc = dict(metrics)
        acc.update(zip(keys, torch._foreach_add([metrics[k] for k in keys], 0.0)))
        return acc
    keys = [k for k, v in acc.items() if torch.is_tensor(v)]
    torch._foreach_add_([acc[k] for k in keys], [metrics[k] for k in keys])
    for k, v in acc.items():
        if not torch.is_tensor(v):
            acc[k] = v + metrics[k]
    return acc


def _fetch(acc: Optional[dict]) -> Dict[str, float]:
    """The accumulated metrics as floats, in one copy from the device."""
    if not acc:
        return {}
    keys = [k for k, v in acc.items() if torch.is_tensor(v)]
    vals = torch.stack([acc[k].float() for k in keys]).cpu().tolist() if keys else []
    return {**{k: float(v) for k, v in acc.items() if not torch.is_tensor(v)},
            **dict(zip(keys, vals))}


@registry.register("trainer", "era5-v2")
@registry.register("trainer", "era5")
class Trainer:
    """fit() loop: epochs x batches, validation, CSV logging, checkpointing,
    early stopping (reference: BaseTrainer.fit, base_trainer.py:503), on
    one device or, with trainer.parallelism, on a mesh of processes.

    `epoch_timings` holds, per epoch run, the host ms to assemble each
    batch (measured on the producer thread: read, decode, stack, pin), the
    ms of each batch's copy to the device, of each train step and of each
    validation batch; device spans are CUDA events, read once an epoch."""

    def __init__(self, conf: dict, model, loss_fn, valid_loss_fn, schema: ChannelSchema,
                 dataset, valid_dataset=None, save_loc: Optional[str] = None,
                 normalizer=None, device="cuda"):
        self.device = resolve_device(device)
        self.conf = conf
        t = conf.get("trainer", {})
        self.model = model
        self.schema = schema
        self.dataset = dataset
        self.valid_dataset = valid_dataset or dataset
        self.save_loc = save_loc or conf.get("save_loc", "./ckpt")
        self.forecast_len = int(conf.get("data", {}).get("forecast_len", 1)) or 1
        self.history_len = int(conf.get("data", {}).get("history_len", 1)) or 1
        self.batch_size = int(t.get("train_batch_size", 1))
        self.valid_batch_size = int(t.get("valid_batch_size", self.batch_size))
        self.num_epoch = int(t.get("num_epoch", t.get("epochs", 1)))
        self.batches_per_epoch = int(t.get("batches_per_epoch", 0))
        self.valid_batches = int(t.get("valid_batches_per_epoch", 0))
        self.stopping_patience = int(t.get("stopping_patience", 999))
        self.use_ema = bool(t.get("use_ema", False))
        self.ema_decay = float(t.get("ema_decay", 0.999))
        self.ensemble_size = int(t.get("ensemble_size", 1))
        bp = t.get("backprop_on_timestep")
        self.backprop_on = [b - 1 for b in bp] if bp else None  # config is 1-based
        self.mesh = self._build_mesh(conf, schema, model)

        from credit_torch.trainers.scheduler import load_scheduler

        self.schedule = load_scheduler(conf)
        self.optimizer = make_optimizer(conf, self.schedule)
        self.loss_fn = loss_fn
        self.valid_loss_fn = valid_loss_fn
        self.normalizer = normalizer

        from credit_torch.grid import grid_from_conf

        grid = grid_from_conf(conf)
        # in-step pipelines (reference: trainer_gen2.py:270-497 applies
        # preblocks and postblocks inside train_one_epoch)
        pre = {phase: tuple(build_preblocks(conf, schema, normalizer, phase=phase, grid=grid))
               for phase in ("ic_only", "per_step")}
        post = self._build_train_postblocks(grid)
        self.train_postblocks = post
        # the trainable postblocks' nets (zero until init_state seeds them
        # or a checkpoint fills them), on the trainer's device
        nets = postblock_nets(post)
        self.nets = nets.to(self.device) if len(nets) else None
        if self.mesh is not None:
            from credit_torch.parallel.sharding import ShardedOptimizer

            params = train_parameters(model, self.nets)
            self.optimizer = ShardedOptimizer(self.optimizer, self.mesh, list(params),
                                              [tuple(p.shape) for p in params.values()])
        self.metrics_fn = None
        if t.get("log_variable_metrics", True):
            from credit_torch.metrics import LatWeightedMetrics

            self.metrics_fn = LatWeightedMetrics(grid, var_names=list(schema.target_names))
        # replay training: bounded pool of model-predicted states re-served
        # as initial conditions (reference: credit/replay_buffer.py
        # ReplayBuffer:77 + its Trainer:384). Costs one small host fetch per
        # batch.
        rp = t.get("replay")
        self.replay = None
        if rp:
            from credit_torch.data.replay_buffer import ReplayBuffer

            rp = rp if isinstance(rp, dict) else {}
            self.replay = ReplayBuffer(capacity=int(rp.get("capacity", 128)),
                                       replay_probability=float(rp.get("probability", 0.5)),
                                       seed=int(conf.get("seed", 0)))
        # external spectral norm (trainer.sn_external): fit() runs the u/v
        # power iterations before each step, as many as the epoch's rollout
        # steps (the in-step form iterates once per forward); the step's
        # forwards then divide by sigma from the frozen vectors
        self.sn_external = bool(t.get("sn_external", False))
        self._step_kw = dict(
            history_len=self.history_len, ema_decay=self.ema_decay if self.use_ema else 0.0,
            ensemble_size=self.ensemble_size, normalizer=normalizer, preblocks=pre["per_step"],
            preblocks_ic=pre["ic_only"], postblocks=tuple(post),
            metrics_fn=self.metrics_fn, return_final_state=self.replay is not None,
            sn_external=self.sn_external, device=self.device, mesh=self.mesh)
        self._step_cache = {}
        # scheduled-rollout sampling: anneal the epoch's rollout length from
        # short to forecast_len (reference: scheduler.py:220
        # annealed_probability, passed as BaseTrainer.fit rollout_scheduler)
        rs = t.get("rollout_schedule")
        self.rollout_schedule = ({"type": rs} if isinstance(rs, str) else rs) if rs else None
        # CRPS-family validation needs >= 2 members (reference:
        # losses/__init__.py CRPS_LOSSES gate on trainer.ensemble_size)
        self.valid_ensemble_size = (max(self.ensemble_size, 2)
                                    if getattr(valid_loss_fn, "is_ensemble", False) else 1)
        self._eval_step = make_eval_step(
            model, valid_loss_fn, schema, self.forecast_len, self.history_len,
            normalizer=normalizer, ensemble_size=self.valid_ensemble_size,
            metrics_fn=self.metrics_fn, preblocks=pre["per_step"], preblocks_ic=pre["ic_only"],
            postblocks=tuple(post), device=self.device, mesh=self.mesh,
            unshard=None if self.mesh is None else self.optimizer.unshard)
        self.epoch_timings: List[dict] = []

    def _build_mesh(self, conf: dict, schema, model):
        """The (dp, tp, domain) mesh of trainer.parallelism over the
        process group (credit_tpu/trainers/trainer.py:383-431; at world
        size 1 too, whose step then reduces over the group), or None
        without a group; raises credit_tpu's ValueErrors for a mesh that
        does not fit."""
        from credit_torch.parallel.mesh import build_mesh, parse_parallelism_conf

        t = conf.get("trainer", {}) or {}
        par = t.get("parallelism") or {}
        self.dp = self.tp = self.domain = 1
        if not par:
            return None
        halo = str(par.get("halo", "gspmd"))
        if halo not in ("gspmd", "explicit"):
            raise ValueError("trainer.parallelism.halo must be 'gspmd' or 'explicit'")
        data = par.get("data", "none")
        if t.get("flatten_optimizer", False) and data not in (None, "none", 0, 1) and int(data) > 1:
            raise ValueError("trainer.flatten_optimizer is incompatible with parallelism.data > 1: "
                             "the flat moment vector cannot be ZeRO-sharded like the params")
        try:
            dp, tp, dom = parse_parallelism_conf(conf)
        except ValueError as e:
            raise ValueError(f"trainer.parallelism does not fit the visible devices: {e}. "
                             f"Set data: none to infer dp, or fix the factors.") from e
        bsz = int(t.get("train_batch_size", 1))
        if dp > 1 and bsz % dp != 0:
            raise ValueError(f"train_batch_size={bsz} not divisible by dp={dp}; "
                             f"change the batch size or trainer.parallelism.data")
        self.dp, self.tp, self.domain = dp, tp, dom
        if not dist_ops.initialized():  # one process, no group: the plain step
            return None
        mesh = build_mesh(dp, tp, dom)
        logger.info("mesh: dp=%d tensor=%d domain=%d (halo exchange explicit%s)", dp, tp, dom,
                    "; gspmd requested, the port has no GSPMD" if halo == "gspmd" else "")
        from credit_torch.parallel.validate import assert_valid_sharding

        assert_valid_sharding(conf, schema, mesh, model)
        mtype = conf.get("model", {}).get("type")
        # every registered model type is lat-sharded; a type registered
        # later without a slab forward runs whole on every domain rank
        if dom > 1 and not getattr(model, "lat_sharded", False):
            logger.warning("model type %s is not lat-sharded: every domain rank computes the "
                           "whole field (the reference's numbers, without the memory saving)",
                           mtype)
        if tp > 1 and not tp_partial_names(model, tp):
            logger.warning("model type %s has no window attention or FF block to split over "
                           "tensor=%d: every tp rank computes the whole model", mtype, tp)
        return mesh

    def noise_keys(self) -> tuple:
        """Keys folded into the train and validation noise seeds: the dp
        coordinate, so that each dp row draws its own noise for its own
        rows of the batch, as one process draws distinct noise for each
        row (tp and domain peers draw the same). Empty for dp row 0 and
        without a mesh, which draw as one process does."""
        c = 0 if self.mesh is None else self.mesh.coord("dp")
        return (c,) if c else ()

    def _train_step_for(self, flen: int):
        """Train step for a scheduled rollout length (cached per length).
        Truncated backprop keeps its meaning under rollout_schedule: when
        every configured step lies past the scheduled length, backprop on
        the last step only (an empty filter must not become None, which
        means all steps)."""
        if flen not in self._step_cache:
            bp = ([b for b in self.backprop_on if b < flen] or [flen - 1]
                  if self.backprop_on else None)
            self._step_cache[flen] = make_train_step(
                self.model, self.loss_fn, self.optimizer, self.schema, flen, bp,
                **self._step_kw)
        return self._step_cache[flen]

    def _scheduled_forecast_len(self, epoch: int, seed: int) -> int:
        """Epoch's rollout length under trainer.rollout_schedule: a geometric
        draw with the annealed termination probability, capped at
        data.forecast_len. Seeded by (seed, epoch) only."""
        if not self.rollout_schedule:
            return self.forecast_len
        from credit_torch.trainers.scheduler import annealed_probability

        rs = self.rollout_schedule
        p = annealed_probability(
            epoch, int(rs.get("max_epochs", self.num_epoch)),
            float(rs.get("min_probability", 0.01)),
            float(rs.get("max_probability", 1.0)))
        rng = np.random.default_rng(seed * 100003 + epoch)
        flen = 1
        while flen < self.forecast_len and rng.random() > p:
            flen += 1
        return flen

    # optuna pruning hook (reference: base_trainer.py trial.report/should_prune)
    optuna_trial = None

    def _optuna_report(self, valid_loss: float, epoch: int):
        self.optuna_trial.report(valid_loss, step=epoch)
        if self.optuna_trial.should_prune():
            import optuna

            raise optuna.TrialPruned()

    def _build_train_postblocks(self, grid):
        """Per-step postblocks run inside the train step (reference:
        trainer_gen2.py applies the model's post_conf pipeline every step).
        Empty unless post_conf activates some; a block that fails to build
        raises."""
        from credit_torch.postblock import build_postblocks

        return build_postblocks(self.conf, self.schema, grid, self.normalizer)

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   noise_seed: int = 0) -> TrainState:
        """Seeded weights for the model (convert_jax.seed_train_: kernels
        he_uniform from `generator`, a CPU generator seeded 0 by default, so
        every device draws the same weights; spectral-norm u/v converged),
        then for the trainable postblocks' nets (flax's initialisers, drawn
        from the same generator), fresh AdamW moments, with use_ema the
        EMA, and the train step's noise generator seeded from
        `noise_seed` and `noise_keys()`."""
        from credit_torch.convert_jax import seed_train_

        generator = generator or torch.Generator().manual_seed(0)
        shards = param_shards(self.model)  # a model ZeRO-3 holds already: seed it whole
        with shards.unsharded() if shards is not None else contextlib.nullcontext():
            seed_train_(self.model, self.conf, generator)
        if self.nets is not None:
            init_postblock_params(self.train_postblocks, generator, self.device)
        state = TrainState.create(self.model, self.optimizer, ema=self.use_ema,
                                  noise_seed=noise_seed, nets=self.nets,
                                  noise_keys=self.noise_keys())
        n = sum(p.numel() for p in self.model.parameters())
        logger.info("model parameters: %.2fM", n / 1e6)
        return state

    def _host_tensor(self, name: str, v: np.ndarray) -> torch.Tensor:
        """A batch array as a tensor, pinned when the device is CUDA (so the
        copy to the card can be asynchronous). Only native float32 reaches
        the model."""
        if v.dtype != np.float32:
            raise TypeError(f"batch array {name!r} is {v.dtype}; the datasets emit native "
                            "float32")
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _batches(self, sampler, dataset, flen: int, replay: bool, prefetch_depth: int):
        """(host batch, t_next, host ms) per sampled batch of init times:
        the batch read from `dataset` (with replayed states swapped in under
        `replay`), its arrays pinned; t_next are its post-rollout time
        indices. Assembled `prefetch_depth` ahead on a producer thread
        (data/prefetch.py) so it overlaps the device steps."""

        def assemble(tidx):
            t0 = time.perf_counter()
            raw = (self.replay.make_batch(dataset, tidx, flen) if replay
                   else dataset.batch(tidx, flen))
            batch = {k: self._host_tensor(k, v) for k, v in raw.items() if v is not None}
            return batch, np.asarray(tidx) + flen, (time.perf_counter() - t0) * 1e3

        if prefetch_depth > 0:
            from credit_torch.data.prefetch import Prefetcher

            return Prefetcher(iter(sampler), assemble, depth=prefetch_depth)
        return map(assemble, sampler)

    def _to_device(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The pinned batch onto the device, asynchronously, on the current
        stream: the step's kernels follow it in stream order, and PyTorch's
        pinned-memory allocator keeps each host block until its copy is
        done."""
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    # ------------------------------------------------------------------
    def fit(self, state: Optional[TrainState] = None, seed: int = 0,
            start_epoch: int = 0) -> TrainState:
        """Train for num_epoch epochs, numbered from `start_epoch` (a resumed
        run continues the epoch count, so the sampler draws the epochs an
        uninterrupted run would). Returns the final state."""
        from credit_torch.data.sampler import MultiStepSampler
        from credit_torch.trainers import preflight as pf

        if state is None:
            state = self.init_state(torch.Generator().manual_seed(seed), noise_seed=seed)
        t = self.conf.get("trainer", {})
        vidx = (self.dataset.valid_init_indices(self.forecast_len)
                if hasattr(self.dataset, "valid_init_indices") else None)
        vvidx = (self.valid_dataset.valid_init_indices(self.forecast_len)
                 if hasattr(self.valid_dataset, "valid_init_indices") else None)
        # one sampler per dp coordinate: this rank's rows of each batch
        # (credit_tpu/trainers/trainer.py:724-753); tp and domain peers
        # draw the same rows
        dp_rank, dp = (0, 1) if self.mesh is None else data_parallel_coords(self.mesh)
        if self.valid_batch_size % dp:
            raise ValueError(f"valid_batch_size={self.valid_batch_size} not divisible by dp={dp} "
                             f"(required for dp-sharded feed)")
        sampler = MultiStepSampler(
            len(self.dataset), self.batch_size // dp, self.forecast_len, self.history_len,
            dp_rank=dp_rank, dp_size=dp, seed=seed,
            batches_per_epoch=self.batches_per_epoch, valid_indices=vidx)
        vsampler = MultiStepSampler(
            len(self.valid_dataset), self.valid_batch_size // dp, self.forecast_len,
            self.history_len, dp_rank=dp_rank, dp_size=dp, seed=seed + 1, shuffle=False,
            batches_per_epoch=self.valid_batches, valid_indices=vvidx)
        primary = dist_ops.is_primary()

        os.makedirs(self.save_loc, exist_ok=True)
        if primary:
            self.schema.save(self.save_loc)
        log_path = os.path.join(self.save_loc, "training_log.csv")
        best_loss = np.inf
        patience = 0

        # preflight (reference: base_trainer.py:573 runs preflight before the
        # epoch loop). 'full' also runs one train step for the CUDA
        # allocator's peak (the reference's synthetic VRAM probe), so it is
        # opt-in.
        pfmode = t.get("preflight", True)
        if pfmode:
            pf.estimate_batch_ram(self.dataset, self.batch_size, self.forecast_len)
            p_gb = sum(p.numel() * p.element_size() for p in state.model.parameters()) / 2**30
            o_gb = sum(v.numel() * v.element_size() for m in ("mu", "nu")
                       for v in state.opt_state[m].values()) / 2**30
            logger.info("preflight: device bytes: params %.3f GB, optimizer %.3f GB", p_gb, o_gb)
            if pfmode == "full":
                raw0 = self.dataset.batch([self.dataset.history_len] * self.batch_size,
                                          self.forecast_len)
                batch0 = self._to_device({k: self._host_tensor(k, v) for k, v in raw0.items()
                                          if v is not None})
                pf.estimate_train_memory(self._train_step_for(self.forecast_len), state, batch0)

        tb = None
        if t.get("use_tensorboard", False):
            try:
                from tensorboardX import SummaryWriter

                tb = SummaryWriter(os.path.join(self.save_loc, "tensorboard"))
            except ImportError:
                logger.warning("tensorboardX not available; skipping TB logging")

        fetch_every = int(t.get("metrics_fetch_every", 50))
        prefetch_depth = int(t.get("prefetch", 2))
        dev = self.device

        for epoch in range(start_epoch, start_epoch + self.num_epoch):
            sampler.set_epoch(epoch)
            t0 = time.time()
            eff_len = self._scheduled_forecast_len(epoch, seed)
            if eff_len != self.forecast_len:
                logger.info("epoch %d scheduled rollout length: %d", epoch, eff_len)
            step_fn = self._train_step_for(eff_len)
            spans = {"assemble_ms": [], "copy": [], "train": [], "valid": []}
            # metrics stay on the device: fetched once an epoch, and for the
            # log line every metrics_fetch_every batches
            acc, n_tr = None, 0
            for host, t_next, host_ms in self._batches(sampler, self.dataset, eff_len,
                                                       self.replay is not None, prefetch_depth):
                spans["assemble_ms"].append(host_ms)
                m0 = _mark(dev)
                batch = self._to_device(host)
                m1 = _mark(dev)
                if self.sn_external:
                    power_iterations(state.model, max(1, eff_len))
                if epoch == start_epoch and n_tr == 0 and pfmode:
                    # the first step may build the kernels (nvcc, a cold
                    # build directory): run it under the startup watchdog,
                    # which warns and never raises (reference: preflight.py:109)
                    state, metrics = pf.first_batch_watchdog(
                        lambda s=state, b=batch: step_fn(s, b),
                        timeout_s=float(t.get("first_batch_timeout", 300.0)),
                        name="first train step (kernel build)")
                else:
                    state, metrics = step_fn(state, batch)
                spans["copy"].append((m0, m1))
                spans["train"].append((m1, _mark(dev)))
                if self.replay is not None:
                    fx = metrics.pop("_final_x").cpu().numpy()
                    for i, tn in enumerate(t_next):
                        # the bound uses the SCHEDULED length: replayed states
                        # must leave room for this epoch's rollout window
                        if tn + eff_len < len(self.dataset):
                            self.replay.add(int(tn), fx[i])
                acc = _accumulate(acc, metrics)
                n_tr += 1
                if fetch_every and n_tr % fetch_every == 0:
                    logger.info("epoch %d batch %d loss %.5f", epoch, n_tr, float(metrics["loss"]))
            vacc, n_va = None, 0
            # the eval noise source varies per (epoch, batch), seeded from
            # seed + 0x5EED as the reference's; torch generators, so the
            # draws are not JAX's keys
            for host, _, host_ms in self._batches(vsampler, self.valid_dataset,
                                                  self.forecast_len, False, prefetch_depth):
                spans["assemble_ms"].append(host_ms)
                m0 = _mark(dev)
                batch = self._to_device(host)
                m1 = _mark(dev)
                gen = torch.Generator(device=dev).manual_seed(
                    _derived_seed(seed + 0x5EED, epoch, n_va, *self.noise_keys()))
                vm = self._eval_step(state, batch, gen)
                spans["copy"].append((m0, m1))
                spans["valid"].append((m1, _mark(dev)))
                vacc = _accumulate(vacc, vm)
                n_va += 1
            acc_h, vacc_h = _fetch(acc), _fetch(vacc)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.epoch_timings.append({
                "epoch": epoch, "assemble_ms": spans["assemble_ms"],
                **{f"{k}_ms": [_span_ms(a, b) for a, b in spans[k]]
                   for k in ("copy", "train", "valid")}})
            tr = float(acc_h.get("loss", np.nan)) / max(n_tr, 1)
            va = float(vacc_h.get("loss")) / n_va if n_va else tr
            dt = time.time() - t0
            logger.info("epoch %d train %.5f valid %.5f (%.1fs)", epoch, tr, va, dt)
            # per-variable columns (reference: base_trainer.py:663-703 writes
            # the full metrics dict to training_log.csv)
            var_cols = sorted(k for k in acc_h if k not in ("loss", "grad_norm", "finite"))
            vvar_cols = sorted(k for k in vacc_h if k != "loss")
            lr = float(self.schedule(state.step))
            write_header = not os.path.exists(log_path)
            with open(log_path if primary else os.devnull, "a", newline="") as f:
                wcsv = csv.writer(f)
                if write_header:
                    wcsv.writerow(["epoch", "train_loss", "valid_loss", "seconds", "lr",
                                   "grad_norm"] + [f"train_{k}" for k in var_cols]
                                  + [f"valid_{k}" for k in vvar_cols])
                wcsv.writerow(
                    [epoch, tr, va, dt, lr, float(acc_h.get("grad_norm", np.nan)) / max(n_tr, 1)]
                    + [float(acc_h[k]) / max(n_tr, 1) for k in var_cols]
                    + [float(vacc_h[k]) / max(n_va, 1) for k in vvar_cols])
            if tb is not None and primary:
                tb.add_scalar("loss/train", tr, epoch)
                tb.add_scalar("loss/valid", va, epoch)
                tb.add_scalar("lr", lr, epoch)
                for k in var_cols:
                    tb.add_scalar(f"train/{k}", float(acc_h[k]) / max(n_tr, 1), epoch)
                tb.flush()
            if self.optuna_trial is not None:
                self._optuna_report(va, epoch)

            self.save_checkpoint(state, epoch)
            if va < best_loss:
                best_loss = va
                patience = 0
                if t.get("save_best_weights"):
                    self.save_checkpoint(state, epoch, tag="best")
            else:
                patience += 1
            dist_ops.barrier("epoch end")
            if patience >= self.stopping_patience:
                logger.info("early stopping at epoch %d", epoch)
                break
        return state

    # ------------------------------------------------------------------
    CHECKPOINT_FILE = "state.pt"

    def save_checkpoint(self, state: TrainState, epoch: int, tag: str = "checkpoint"):
        """Full training state in `save_loc/tag/state.pt` (torch.save): the
        model's parameters and spectral-norm u/v buffers (and the postblock
        nets' as `_postblocks.<i>.<name>`), `step`, the
        optimizer state (AdamW moments and count; MultiSteps' mean and
        mini-step), the EMA and the noise generator's state (reference: base_trainer.
        _save_checkpoint; the directory names are credit_tpu's, the format
        is the port's own). The previous checkpoint is kept as
        backup_checkpoint (save_backup_weights). The file is written beside
        the old one and renamed into place; epoch.txt, the resume marker,
        is written last. Under a mesh every rank takes part (ZeRO-3's
        parameters, the sharded optimizer state and EMA are gathered whole,
        and with dp > 1 each dp row's noise generator state, `noise_dp`) and
        the primary writes."""
        opt_state, ema = state.opt_state, state.ema_params
        noise = None if state.noise is None else state.noise.get_state()
        noise_dp = None
        weights = self.model_tensors(state)
        if self.mesh is not None:
            opt_state = self.optimizer.full_state(opt_state)
            if ema is not None:
                ema = dict(zip(ema, self.optimizer.whole(ema)))
            if noise is not None and self.dp > 1:  # ranks in (dp, tp, domain) order
                rows = dist_ops.all_gather(noise.to(self.device)[None], 0).cpu()
                noise_dp = [r.clone() for r in rows[::self.tp * self.domain]]
            if not dist_ops.is_primary():
                return
        path = os.path.join(self.save_loc, tag)
        ckpt = os.path.join(path, self.CHECKPOINT_FILE)
        if (tag == "checkpoint" and os.path.exists(path)
                and self.conf.get("trainer", {}).get("save_backup_weights", True)):
            backup = os.path.join(self.save_loc, "backup_checkpoint")
            shutil.rmtree(backup, ignore_errors=True)
            shutil.copytree(path, backup)
        os.makedirs(path, exist_ok=True)
        payload = {"model": weights, "step": state.step,
                   "opt_state": opt_state, "ema_params": ema,
                   "noise": noise, "noise_dp": noise_dp}
        torch.save(payload, ckpt + ".tmp")
        os.replace(ckpt + ".tmp", ckpt)
        with open(os.path.join(self.save_loc, "epoch.txt"), "w") as f:
            f.write(str(epoch))

    def model_tensors(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The model's state_dict with whole tensors (ZeRO-3's chunks
        gathered, a collective under a mesh), and the postblock nets' as
        `_postblocks.<i>.<name>`."""
        shards = param_shards(state.model)
        weights = (state.model.state_dict() if shards is None
                   else shards.state_dict(state.model))
        if state.nets is not None:
            weights.update((f"_postblocks.{k}", v) for k, v in state.nets.state_dict().items())
        return weights

    def load_checkpoint(self, state: TrainState, tag: str = "checkpoint",
                        load_optimizer: bool = True) -> TrainState:
        """`state` with the checkpoint's parameters, u/v, postblock nets,
        step, EMA and noise generator state (where it has them), and its
        optimizer state unless load_optimizer is off. The tensors are copied
        into the state's own, on its device (under a mesh, this rank's
        chunks of the whole tensors the checkpoint holds)."""
        path = os.path.join(self.save_loc, tag, self.CHECKPOINT_FILE)
        saved = torch.load(path, map_location=self.device, weights_only=True)
        pre = "_postblocks."
        weights = {k: v for k, v in saved["model"].items() if not k.startswith(pre)}
        shards = param_shards(state.model)
        if shards is None:
            state.model.load_state_dict(weights)
        else:
            shards.load_state_dict(state.model, weights)
        if state.nets is not None:
            state.nets.load_state_dict({k[len(pre):]: v for k, v in saved["model"].items()
                                        if k.startswith(pre)})
        opt_state = state.opt_state
        sharded = self.mesh is not None and hasattr(self.optimizer, "load_full_state")
        # a converted checkpoint (convert-checkpoint) holds no optimizer
        # state: the state's own stays, as credit_tpu restores such a one
        load_optimizer = load_optimizer and saved.get("opt_state") is not None
        if load_optimizer and sharded:
            opt_state = self.optimizer.load_full_state(opt_state, saved["opt_state"])
        elif load_optimizer:
            with torch.no_grad():
                for name, part in opt_state.items():
                    if isinstance(part, dict):
                        for k, v in part.items():
                            v.copy_(saved["opt_state"][name][k])
            opt_state = {**opt_state, **{k: v for k, v in saved["opt_state"].items()
                                         if not isinstance(v, dict)}}
        ema = state.ema_params
        if ema is not None and saved.get("ema_params") is not None:
            with torch.no_grad():
                for k, v in ema.items():
                    w = saved["ema_params"][k]
                    v.copy_(self.optimizer.view_whole(k, w) if sharded else w)
        if state.noise is not None and saved.get("noise") is not None:
            # this dp row's generator where the checkpoint has one for each
            # row, else row 0's, forked for another row
            c = 0 if self.mesh is None else self.mesh.coord("dp")
            rows = saved.get("noise_dp")
            mine = rows is not None and len(rows) == self.dp
            state.noise.set_state((rows[c] if mine else saved["noise"]).cpu())
            if c and not mine:
                draw = torch.randint(2**31 - 1, (1,), generator=state.noise,
                                     device=state.noise.device)
                state.noise.manual_seed(_derived_seed(int(draw), c))
        return TrainState(saved["step"], state.model, opt_state, ema, state.noise, state.nets)

    def checkpoint_epoch(self) -> int:
        """The last epoch a checkpoint was written for (epoch.txt); -1 for
        one no fit wrote (convert-checkpoint's), so a fit resumed from it
        starts at epoch 0."""
        path = os.path.join(self.save_loc, "epoch.txt")
        if not os.path.exists(path):
            return -1
        with open(path) as f:
            return int(f.read())


def load_trainer(conf: dict):
    """Registry dispatch (reference: credit/trainers/__init__.py:81): every
    reference trainer key resolves here; the per-domain classes' deltas are
    config-driven in this design; `ic-opt` and `era5-ic-opt` resolve to
    `optimize_initial_condition`, a function, as in credit_tpu."""
    from credit_torch.trainers import diffusion  # noqa: F401  (registers era5-diffusion)
    from credit_torch.trainers import ic_optimization  # noqa: F401  (registers ic-opt)

    ttype = conf.get("trainer", {}).get("type", "era5-v2")
    aliases = {"era5-gen1": "era5", "cam": "era5",
               "gen2": "era5-v2", "era5-gen2": "era5-v2",
               "era5-ensemble": "era5-v2", "era5-ensemble-v2": "era5-v2",
               "universal": "era5-v2",
               "les": "era5-v2", "standard-les": "era5-v2",
               "wrf": "era5-v2", "standard-wrf": "era5-v2",
               "multi-step-wrf": "era5-v2",
               "conus404": "era5-v2", "downscaling": "era5-v2",
               "samudra": "era5-v2",
               "era5-ic-opt": "ic-opt"}
    name = aliases.get(ttype, ttype)
    try:
        return registry.get("trainer", name)
    except KeyError:
        logger.warning("unknown trainer type %r; using era5-v2", ttype)
        return registry.get("trainer", "era5-v2")

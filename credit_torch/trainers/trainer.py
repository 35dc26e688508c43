"""Multi-step truncated-BPTT train step: port of credit_tpu/trainers/trainer.py
(`TrainState`, `make_optimizer`, `make_train_step`).

Per optimizer step, for rollout steps s = 0..forecast_len-1:

    y_pred_s = model(x_s)              (train mode: one SN power iteration)
    if s in backprop_on_timestep: backward of loss_s, gradients summed
    x_{s+1} = update_x(x_s, y_pred_s, forcing_s), detached

then the summed gradients and losses are divided by the number of
backpropagated steps, the NaN guard zeroes the gradients of a non-finite
loss (the AdamW moments still advance; the parameters stay), AdamW with
optax's formulas updates the parameters, and the EMA follows with decay
min(decay, (1+n)/(10+n)). The reference's one jitted program becomes eager
PyTorch on the model's own parameters and u/v buffers, updated in place.

The TPU levers `flatten_optimizer`, `scan_blocks` and `remat` are accepted
and ignored. `Trainer.fit`, the eval step, the normalizer, pre/postblocks,
ensembles, metrics and `sn_external` are not ported yet (ROADMAP queue 1,
item 6) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from credit_torch import resolve_device
from credit_torch.data.channels import ChannelSchema
from credit_torch.trainers.scheduler import Schedule


@dataclasses.dataclass
class TrainState:
    """step: optimizer steps taken; model: holds the parameters and the
    spectral u/v buffers; opt_state: the optimizer's (`AdamW.init`);
    ema_params: name -> EMA of each parameter, or None (EMA off)."""

    step: int
    model: torch.nn.Module
    opt_state: dict
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: "AdamW", ema: bool = False) -> "TrainState":
        params = dict(model.named_parameters())
        ema_params = {k: p.detach().clone() for k, p in params.items()} if ema else None
        return cls(0, model, optimizer.init(params), ema_params)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))).float())


class AdamW:
    """optax.chain([clip_by_global_norm(clip)], adamw(schedule, b1, b2,
    eps=1e-8, eps_root=0, weight_decay)) in PyTorch: moments with bias
    correction at the 1-based count, decoupled decay applied to every leaf,
    the learning rate read from `schedule` at the 0-based count."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip: float = 0.0):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.clip = weight_decay, clip

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        zeros = lambda: {k: torch.zeros_like(p, memory_format=torch.preserve_format)  # noqa: E731
                         for k, p in params.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def update(self, grads: List[torch.Tensor], state: dict, params: List[torch.Tensor]):
        """(updates, new state) for gradients and parameters listed in the
        order of the state's keys. The moments are updated in place."""
        grads = list(grads)
        if self.clip > 0:
            gnorm = global_norm(grads)
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


def make_optimizer(conf: dict, schedule: Schedule) -> AdamW:
    """AdamW betas (0.9, 0.95) with the trainer section's `weight_decay`
    and, where `grad_max_norm` > 0, global-norm clipping first."""
    t = conf.get("trainer", {})
    if int(t.get("grad_accum_every", 1)) > 1:
        raise NotImplementedError("grad_accum_every is not ported yet (ROADMAP queue 1, item 6)")
    return AdamW(schedule, weight_decay=float(t.get("weight_decay", 0.0)),
                 clip=float(t.get("grad_max_norm", 0.0) or 0.0))


def _ema_decay(base: float, n: int) -> float:
    return min(base, (1.0 + n) / (10.0 + n))


def make_train_step(model, loss_fn: Callable, optimizer: AdamW, schema: ChannelSchema,
                    forecast_len: int = 1, backprop_on_timestep: Optional[Sequence[int]] = None,
                    history_len: int = 1, ema_decay: float = 0.0, ensemble_size: int = 1,
                    normalizer=None, preblocks=(), preblocks_ic=(), postblocks=(),
                    metrics_fn=None, return_final_state: bool = False,
                    sn_external: bool = False, device="cuda"):
    """The multi-step train step, `train_step(state, batch) -> (state,
    metrics)` with state.model being `model`. batch: {'x': (B, T_hist, H, W,
    C_in), 'y': (B, S, H, W, C_t), 'forcing': (B, S, H, W, n_dyn) or absent},
    in normalized units. metrics: 'loss' and 'grad_norm' (0-d tensors) and
    'finite' (1.0 or 0.0). The step updates the model in place."""
    unported = {"normalizer": normalizer is not None, "preblocks": bool(preblocks),
                "preblocks_ic": bool(preblocks_ic), "postblocks": bool(postblocks),
                "ensembles": ensemble_size > 1, "metrics_fn": metrics_fn is not None,
                "return_final_state": return_final_state, "sn_external": sn_external}
    for name, used in unported.items():
        if used:
            raise NotImplementedError(f"make_train_step: {name} is not ported yet "
                                      "(ROADMAP queue 1, item 6)")
    dev = resolve_device(device)
    bp = set(backprop_on_timestep or range(forecast_len))
    n_bp = max(len(bp), 1)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        mdl = state.model
        mdl.train()
        params = dict(mdl.named_parameters())
        for p in params.values():
            p.grad = None
        x = batch["x"].to(dev)
        forcing = batch.get("forcing")
        total = torch.zeros((), device=dev)
        for s in range(forecast_len):
            y_t = batch["y"][:, s:s + 1].to(dev)
            if s in bp:
                y_pred = mdl(x)
                loss = loss_fn(y_t, y_pred)
                loss.backward()  # sums into .grad across the backpropagated steps
                total = total + loss.detach()
            else:
                with torch.no_grad():
                    y_pred = mdl(x)
            if s + 1 < forecast_len:
                # the next input is detached, as the reference's stop_gradient
                f_next = None if forcing is None else forcing[:, s:s + 1].to(dev)
                with torch.no_grad():
                    new = schema.update_x(x[:, -1:], y_pred[:, -1:], f_next)
                    x = torch.cat([x[:, 1:], new], dim=1) if history_len > 1 else new
        names = list(state.opt_state["mu"])
        plist = [params[k] for k in names]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in plist]
        torch._foreach_div_(grads, float(n_bp))
        mean_loss = total / n_bp
        finite = bool(torch.isfinite(mean_loss))
        with torch.no_grad():
            if not finite:  # NaN guard: zero grads, moments advance, params stay
                for g in grads:
                    g.zero_()
            updates, opt_state = optimizer.update(grads, state.opt_state, plist)
            if finite:
                torch._foreach_add_(plist, updates)
            ema = state.ema_params
            if ema is not None:
                d = _ema_decay(ema_decay, state.step)
                evals = [ema[k] for k in names]
                torch._foreach_mul_(evals, d)
                torch._foreach_add_(evals, plist, alpha=1.0 - d)
            gnorm = global_norm(grads)
        for p in plist:
            p.grad = None
        new_state = TrainState(state.step + 1, mdl, opt_state, ema)
        return new_state, {"loss": mean_loss, "grad_norm": gnorm, "finite": float(finite)}

    return train_step

"""Learning-rate schedules: port of credit_tpu/trainers/scheduler.py.

A schedule maps optax's update count, which starts at 0 for the first
update, to a learning rate (a Python float). It is evaluated at that count,
as optax's scale_by_learning_rate does, and not at torch's LambdaLR index.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def fn(count):
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return fn


def _join(schedules, boundaries) -> Schedule:
    """optax.join_schedules: each schedule counts from its boundary."""

    def fn(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return fn


def _warmup_cosine_decay(init: float, peak: float, warmup_steps: int, decay_steps: int,
                         end: float) -> Schedule:
    """optax.warmup_cosine_decay_schedule."""
    alpha = 0.0 if peak == 0.0 else end / peak
    return _join([_linear(init, peak, warmup_steps),
                  _cosine(peak, decay_steps - warmup_steps, alpha)], [warmup_steps])


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 0.0) -> Schedule:
    """Linear warmup then cosine anneal."""
    return _warmup_cosine_decay(0.0, base_lr, max(warmup_steps, 1),
                                max(total_steps, warmup_steps + 1), min_lr)


def cosine_warmup_restarts(base_lr: float, first_cycle_steps: int, cycle_mult: float = 1.0,
                           warmup_steps: int = 0, gamma: float = 1.0, min_lr: float = 0.0,
                           n_cycles: int = 8) -> Schedule:
    """Cosine annealing with warm restarts and a per-cycle peak decay gamma."""
    schedules, boundaries = [], []
    t, steps, peak = 0, first_cycle_steps, base_lr
    for _ in range(n_cycles):
        schedules.append(_warmup_cosine_decay(min_lr, peak, max(warmup_steps, 1), steps, min_lr))
        t += steps
        boundaries.append(t)
        steps = int(steps * cycle_mult)
        peak *= gamma
    return _join(schedules, boundaries[:-1])


def lambda_phased(base_lr: float, warmup_steps: int = 1000, phase1_steps: int = 100000,
                  decay: float = 0.5) -> Schedule:
    """Warmup, hold, then stepwise decay."""

    def fn(count):
        warm = min(count / max(warmup_steps, 1), 1.0)
        phase = math.floor(max(count - phase1_steps, 0) / max(phase1_steps, 1))
        return base_lr * warm * decay ** phase

    return fn


def constant(base_lr: float) -> Schedule:
    return lambda count: base_lr


def annealed_probability(epoch: int, max_epochs: int = 100, min_probability: float = 0.01,
                         max_probability: float = 1.0) -> float:
    """Scheduled-rollout sampling probability annealed over epochs."""
    frac = min(max(epoch / max(max_epochs, 1), 0.0), 1.0)
    return max_probability - frac * (max_probability - min_probability)


def load_scheduler(conf: dict) -> Optional[Schedule]:
    """The schedule of the config's trainer section; constant lr without one."""
    t = conf.get("trainer", {})
    lr = float(t.get("learning_rate", 1e-4))
    if not t.get("use_scheduler"):
        return constant(lr)
    sconf = t.get("scheduler", {}) or {}
    kind = sconf.get("scheduler_type", "cosine-annealing")
    if kind in ("cosine-annealing", "warmup-cosine"):
        return warmup_cosine(
            lr, int(sconf.get("warmup_steps", sconf.get("first_cycle_steps", 1000) // 20)),
            int(sconf.get("total_steps", sconf.get("first_cycle_steps", 100000))),
            float(sconf.get("min_lr", 0.0)))
    if kind in ("cosine-annealing-restarts",):
        return cosine_warmup_restarts(
            lr, int(sconf.get("first_cycle_steps", 10000)), float(sconf.get("cycle_mult", 1.0)),
            int(sconf.get("warmup_steps", 500)), float(sconf.get("gamma", 1.0)),
            float(sconf.get("min_lr", 0.0)))
    if kind == "lambda":
        return lambda_phased(lr)
    return constant(lr)

"""Autoregressive rollout (port of credit_tpu/rollout.py):

    step: x -> y_pred = model(x); x' = update_x(x, y_pred, forcing_next)

The reference's one-dispatch `lax.scan` becomes a Python loop: PyTorch runs
eagerly and every step's kernels are queued on the card without a host
round trip. The position-bias tables are computed on the first step and
reused by the rest (`layers.position_bias_cache`).

`RolloutEngine` runs in normalized space with its `Normalizer` and applies
its postblocks every step, as the reference's, carrying the stateful
blocks' states (the SKEBS pattern) from step to step. `RolloutEngine.run` hands
each prediction to the host through pinned memory on a side CUDA stream
and to a pool of writer threads, so that the next steps run on the card
while earlier ones are copied and written.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from credit_torch import resolve_device
from credit_torch.data.channels import ChannelSchema
from credit_torch.data.normalize import Normalizer
from credit_torch.models.layers import position_bias_cache
from credit_torch.parallel import context as par_ctx
from credit_torch.postblock import apply_postblocks
from credit_torch.postblock.stochastic import (apply_postblocks_stateful, init_postblock_states,
                                               split_postblock_params)


def _advance(schema: ChannelSchema, x, y_pred, forcing, history_len: int):
    new_frame = schema.update_x(x[:, -1:], y_pred[:, -1:], forcing)
    if history_len > 1:
        x_next = torch.cat([x[:, 1:], new_frame], dim=1)
    else:
        x_next = new_frame
    return x_next.to(x.dtype)  # keep the carry's dtype


def make_scan_rollout(model, schema: ChannelSchema, n_steps: int, history_len: int = 1,
                      with_forcing: bool = False, device="cuda", mesh=None):
    """N-step rollout. Returns run(x0[, forcings]) -> (final_x, stats) where
    stats is (n_steps, C): each step's per-channel mean of y_pred over
    (B, T, H, W). forcings: (S, B, 1, H, W, n_dyn) when with_forcing. No
    postblocks, as in the reference's scan rollout. With a `mesh`
    (parallel.mesh.Mesh; credit_tpu/rollout.py:222-241) the steps run under
    explicit_halo(mesh): each dp coordinate rolls out its rows of x0 (the
    lat-sharded models split latitude over the domain ranks), and the final
    state and the means are gathered whole over dp."""
    dev = resolve_device(device)

    @torch.no_grad()
    def run(x0: torch.Tensor, forcings: Optional[torch.Tensor] = None):
        x = x0.to(dev)
        dp = 1 if mesh is None else mesh.shape["dp"]
        if dp > 1:
            x = x.chunk(dp)[mesh.coord("dp")]
            if with_forcing:
                forcings = forcings.chunk(dp, dim=1)[mesh.coord("dp")]
        stats = []
        with position_bias_cache(model), par_ctx.explicit_halo(mesh):
            for s in range(n_steps):
                y = model(x)
                x = _advance(schema, x, y, forcings[s].to(dev) if with_forcing else None,
                             history_len)
                stats.append(y.float().mean(dim=(0, 1, 2, 3)))
        stats = torch.stack(stats)
        if dp > 1:
            from credit_torch.parallel import distributed as D

            x = D.all_gather(x, 0, mesh.group("dp"))
            stats = D.all_reduce(stats, mesh.group("dp")) / dp
        return x, stats.to(y.dtype)

    return run


class RolloutEngine:
    """Step-by-step rollout that hands each prediction back to the host
    (reference: credit_tpu/rollout.py:39-207).

    The model runs in normalized space: `run` normalizes the input and the
    forcing on entry and denormalizes only what it emits. Each step applies
    `postblocks` (e.g. `postblock.build_postblocks`) to the model's
    prediction, with the step's input, before the next input is spliced.
    Stateful postblocks keep their states across steps (and `run` calls)
    until `reset`, which the first step does for a batch of its size; a
    noisy model and the stateful blocks draw from the engine's generator
    (seeded by `reset`, 0 unless given). `postblock_params` are the
    trainable blocks' nets' tensors as a checkpoint holds them
    (`_postblocks.<i>.<name>`); the engine splits them off by block. With a
    `mesh` each step runs under explicit_halo(mesh) (a lat-sharded model
    splits latitude over the domain ranks; every rank gets the whole
    prediction)."""

    def __init__(self, model, schema: ChannelSchema, normalizer: Optional[Normalizer] = None,
                 history_len: int = 1, postblocks: Optional[Sequence[Callable]] = None,
                 postblock_params: Optional[Dict[str, torch.Tensor]] = None, device="cuda",
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = model
        self.schema = schema
        self.normalizer = normalizer
        self.history_len = history_len
        self.postblocks = list(postblocks or [])
        self.pb_params = None
        if postblock_params:
            self.pb_params = {i: {k: v.to(self.device) for k, v in t.items()}
                              for i, t in split_postblock_params(postblock_params).items()}
        self._has_stateful = any(getattr(b, "is_stateful", False) for b in self.postblocks)
        self._stochastic = getattr(model, "stochastic", False)
        self._states: dict = {}
        self._gen: Optional[torch.Generator] = None
        self._ring: Optional[List[torch.Tensor]] = None  # run's pinned host buffers
        self.copy_ms: List[float] = []
        self._cache = contextlib.ExitStack()
        self._cache.enter_context(position_bias_cache(model))

    def close(self):
        """Drop the cached position-bias tables."""
        self._cache.close()

    def reset(self, batch_size: int = 1, seed: int = 0):
        """(Re)initialise the stateful postblocks' states (the SKEBS pattern)
        for `batch_size` and the engine's generator from `seed`."""
        self._states = init_postblock_states(self.postblocks, batch_size, self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def step(self, x: torch.Tensor, forcing_next: Optional[torch.Tensor] = None):
        """x: (B, T_hist, H, W, C_in) -> (y_pred, x_next), both in the
        model's (normalized) space; y_pred has passed the postblocks."""
        x = x.to(self.device)
        if self._gen is None or (self._has_stateful and not self._states):
            self.reset(x.shape[0])
        with par_ctx.explicit_halo(self.mesh):
            y = self.model(x, generator=self._gen) if self._stochastic else self.model(x)
        if self._has_stateful:
            y, self._states = apply_postblocks_stateful(self.postblocks, y, x, self._states,
                                                        self._gen, self.pb_params)
        else:
            y = apply_postblocks(self.postblocks, y, x)
        f = None if forcing_next is None else forcing_next.to(self.device)
        return y, _advance(self.schema, x, y, f, self.history_len)

    @torch.no_grad()
    def fresh_step(self, x: torch.Tensor, forcing_next: Optional[torch.Tensor] = None,
                   seed: int = 0):
        """`step` from fresh stateful-postblock states and a generator
        seeded `seed`, leaving the engine's own states and generator as they
        were: credit_tpu's pure jitted step with fixed states and key, which
        its ensemble run_rollout breeds with."""
        saved = self._states, self._gen
        try:
            self.reset(x.shape[0], seed)
            return self.step(x, forcing_next)
        finally:
            self._states, self._gen = saved

    def run(self, x0, n_steps: int,
            forcing_provider: Optional[Callable[[int], np.ndarray]] = None,
            on_step: Optional[Callable[[int, np.ndarray], None]] = None,
            denormalize: bool = True, async_writers: int = 2,
            x0_normalized: bool = False) -> List[np.ndarray]:
        """Run n_steps. Returns the (denormalized) f32 predictions as numpy
        arrays that own their memory, or streams them to on_step(step, y)
        on `async_writers` writer threads and returns []; every writer has
        finished, and a writer's exception is raised, when run returns. On
        CUDA the y given to on_step is a view of a pinned host buffer that
        is reused once on_step returns: copy what must outlive the call.
        forcing_provider(s) gives the (B, 1, H, W, n_dyn) forcing of the
        next input, or None. x0 and the forcing are in physical units when
        a normalizer is set: they are normalized on entry (x0 not with
        x0_normalized, for a state already in the model's space). After each step
        the blocks with `write_rollout_debug_files` dump their state
        (`dump_debug(s, state)`, a host read). On CUDA, `copy_ms` holds
        each step's device-to-host copy time afterwards."""
        x = torch.as_tensor(x0).to(self.device)
        if self.normalizer is not None and not x0_normalized:
            x = self.normalizer.normalize_input(x)
        outs: List[np.ndarray] = [None] * n_steps if on_step is None else []

        def collect(s, y):
            outs[s] = y.copy()

        copies = _HostCopies(self, async_writers + 1)
        with concurrent.futures.ThreadPoolExecutor(max(async_writers, 1)) as pool:
            try:
                for s in range(n_steps):
                    f = forcing_provider(s + 1) if forcing_provider is not None else None
                    if f is not None:
                        f = torch.as_tensor(f).to(self.device)
                        if self.normalizer is not None:
                            f = self.normalizer.normalize_forcing(f, self.schema)
                        f = f.to(x.dtype)
                    y, x = self.step(x, f)
                    for i, pb in enumerate(self.postblocks):
                        if getattr(pb, "write_rollout_debug_files", False) and i in self._states:
                            pb.dump_debug(s, self._states[i])
                    if denormalize and self.normalizer is not None:
                        y = self.normalizer.denormalize_target(y)
                    copies.submit(pool, s, y.float(), on_step or collect)
                copies.wait_all()
            finally:
                copies.cancel()
        self.copy_ms = copies.elapsed_ms()
        return outs if on_step is None else []


class _HostCopies:
    """The host hand-off of `RolloutEngine.run`. On CUDA, a step's
    prediction is copied into one of a ring of pinned host buffers on a
    side stream, after an event recorded behind the step on the compute
    stream; a writer thread waits for the copy's event and then gets the
    buffer as a numpy view. A slot is reused only after the writer holding
    it has finished, which also bounds how many predictions wait behind
    slow writes. On the CPU the copy is a contiguous clone."""

    def __init__(self, engine: "RolloutEngine", slots: int):
        self.engine = engine
        self.cuda = engine.device.type == "cuda"
        self.slots = slots
        self.futures: List[Optional[concurrent.futures.Future]] = [None] * slots
        self.events = []
        if self.cuda:
            self.stream = torch.cuda.Stream(engine.device)

    def _buffers(self, y: torch.Tensor) -> List[torch.Tensor]:
        ring = self.engine._ring
        if ring is None or len(ring) != self.slots or ring[0].shape != y.shape:
            ring = [torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                    for _ in range(self.slots)]
            self.engine._ring = ring
        return ring

    def submit(self, pool, s: int, y: torch.Tensor, emit: Callable) -> None:
        k = s % self.slots
        if self.futures[k] is not None:
            self.futures[k].result()  # the slot's writer is done (or raises)
        if not self.cuda:
            host = y.contiguous().clone().numpy()
            self.futures[k] = pool.submit(emit, s, host)
            return
        buf = self._buffers(y)[k]
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.engine.device))
        start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            start.record(self.stream)
            buf.copy_(y, non_blocking=True)
            done.record(self.stream)
        y.record_stream(self.stream)  # y's memory stays until the copy has run
        self.events.append((start, done))

        def write():
            done.synchronize()
            emit(s, buf.numpy())

        self.futures[k] = pool.submit(write)

    def wait_all(self) -> None:
        for fu in self.futures:
            if fu is not None:
                fu.result()

    def cancel(self) -> None:
        for fu in self.futures:
            if fu is not None:
                fu.cancel()

    def elapsed_ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.events]


def rk4_step(apply_fn, x: torch.Tensor) -> torch.Tensor:
    """Runge-Kutta-4 composition of the single-step model (reference:
    crossformer.py:738 rk4 -- treats the model output as a state estimate
    and averages four staged evaluations). apply_fn: x -> y_pred with
    matching prognostic channel count."""
    k1 = apply_fn(x)
    k2 = apply_fn(x + 0.5 * (k1 - x))
    k3 = apply_fn(x + 0.5 * (k2 - x))
    k4 = apply_fn(x + (k3 - x))
    return (k1 + 2 * k2 + 2 * k3 + k4) / 6.0

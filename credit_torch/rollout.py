"""Autoregressive rollout (port of credit_tpu/rollout.py):

    step: x -> y_pred = model(x); x' = update_x(x, y_pred, forcing_next)

The reference's one-dispatch `lax.scan` becomes a Python loop: PyTorch runs
eagerly and every step's kernels are queued on the card without a host
round trip. The position-bias tables are computed on the first step and
reused by the rest (`layers.position_bias_cache`).

`RolloutEngine` runs in normalized space with its `Normalizer` and applies
its postblocks every step, as the reference's. Not ported yet (ROADMAP
queue 1, item 5): `rk4_step`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from credit_torch import resolve_device
from credit_torch.data.channels import ChannelSchema
from credit_torch.data.normalize import Normalizer
from credit_torch.models.layers import position_bias_cache
from credit_torch.postblock import apply_postblocks
from credit_torch.postblock.stochastic import check_stateless


def _advance(schema: ChannelSchema, x, y_pred, forcing, history_len: int):
    new_frame = schema.update_x(x[:, -1:], y_pred[:, -1:], forcing)
    if history_len > 1:
        x_next = torch.cat([x[:, 1:], new_frame], dim=1)
    else:
        x_next = new_frame
    return x_next.to(x.dtype)  # keep the carry's dtype


def make_scan_rollout(model, schema: ChannelSchema, n_steps: int, history_len: int = 1,
                      with_forcing: bool = False, device="cuda"):
    """N-step rollout. Returns run(x0[, forcings]) -> (final_x, stats) where
    stats is (n_steps, C): each step's per-channel mean of y_pred over
    (B, T, H, W). forcings: (S, B, 1, H, W, n_dyn) when with_forcing. No
    postblocks, as in the reference's scan rollout."""
    dev = resolve_device(device)

    @torch.no_grad()
    def run(x0: torch.Tensor, forcings: Optional[torch.Tensor] = None):
        x = x0.to(dev)
        stats = []
        with position_bias_cache(model):
            for s in range(n_steps):
                y = model(x)
                x = _advance(schema, x, y, forcings[s].to(dev) if with_forcing else None,
                             history_len)
                stats.append(y.float().mean(dim=(0, 1, 2, 3)).to(y.dtype))
        return x, torch.stack(stats)

    return run


class RolloutEngine:
    """Step-by-step rollout that hands each prediction back to the host
    (reference: credit_tpu/rollout.py:39-207).

    The model runs in normalized space: `run` normalizes the input and the
    forcing on entry and denormalizes only what it emits. Each step applies
    `postblocks` (e.g. `postblock.build_postblocks`) to the model's
    prediction, with the step's input, before the next input is spliced.
    Stateful postblocks are not ported and raise."""

    def __init__(self, model, schema: ChannelSchema, normalizer: Optional[Normalizer] = None,
                 history_len: int = 1, postblocks: Optional[Sequence[Callable]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.schema = schema
        self.normalizer = normalizer
        self.history_len = history_len
        self.postblocks = list(postblocks or [])
        check_stateless(self.postblocks)
        self._cache = contextlib.ExitStack()
        self._cache.enter_context(position_bias_cache(model))

    def close(self):
        """Drop the cached position-bias tables."""
        self._cache.close()

    @torch.no_grad()
    def step(self, x: torch.Tensor, forcing_next: Optional[torch.Tensor] = None):
        """x: (B, T_hist, H, W, C_in) -> (y_pred, x_next), both in the
        model's (normalized) space; y_pred has passed the postblocks."""
        x = x.to(self.device)
        y = self.model(x)
        y = apply_postblocks(self.postblocks, y, x)
        f = None if forcing_next is None else forcing_next.to(self.device)
        return y, _advance(self.schema, x, y, f, self.history_len)

    def run(self, x0, n_steps: int,
            forcing_provider: Optional[Callable[[int], np.ndarray]] = None,
            on_step: Optional[Callable[[int, np.ndarray], None]] = None,
            denormalize: bool = True) -> List[np.ndarray]:
        """Run n_steps. Returns the (denormalized) predictions as numpy
        arrays, or streams them to on_step(step, y) and returns [].
        forcing_provider(s) gives the (B, 1, H, W, n_dyn) forcing of the next
        input, or None. x0 and the forcing are in physical units when a
        normalizer is set: they are normalized on entry."""
        x = torch.as_tensor(x0).to(self.device)
        if self.normalizer is not None:
            x = self.normalizer.normalize_input(x)
        outs: List[np.ndarray] = []
        for s in range(n_steps):
            f = forcing_provider(s + 1) if forcing_provider is not None else None
            if f is not None:
                f = torch.as_tensor(f).to(self.device)
                if self.normalizer is not None:
                    f = self.normalizer.normalize_forcing(f, self.schema)
                f = f.to(x.dtype)
            y, x = self.step(x, f)
            if denormalize and self.normalizer is not None:
                y = self.normalizer.denormalize_target(y)
            y_host = y.float().cpu().numpy()
            if on_step is not None:
                on_step(s, y_host)
            else:
                outs.append(y_host)
        return outs

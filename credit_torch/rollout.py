"""Autoregressive rollout (port of credit_tpu/rollout.py):

    step: x -> y_pred = model(x); x' = update_x(x, y_pred, forcing_next)

The reference's one-dispatch `lax.scan` becomes a Python loop: PyTorch runs
eagerly and every step's kernels are queued on the card without a host
round trip. The position-bias tables are computed on the first step and
reused by the rest (`layers.position_bias_cache`).

Not ported yet (ROADMAP queue 1, item 5): the `Normalizer`, postblocks in
`RolloutEngine`, and `rk4_step`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from credit_torch import resolve_device
from credit_torch.data.channels import ChannelSchema
from credit_torch.models.layers import position_bias_cache


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
    (B, T, H, W). forcings: (S, B, 1, H, W, n_dyn) when with_forcing."""
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
    """Step-by-step rollout that hands each prediction back to the host.

    The model runs in normalized space; `normalizer` and `postblocks` are
    not ported yet and raise."""

    def __init__(self, model, schema: ChannelSchema, normalizer=None, history_len: int = 1,
                 postblocks: Optional[Sequence[Callable]] = None, device="cuda"):
        if normalizer is not None:
            raise NotImplementedError("Normalizer is not ported yet (ROADMAP queue 1, item 5)")
        if postblocks:
            raise NotImplementedError(
                "postblocks in RolloutEngine are not ported yet (ROADMAP queue 1, item 7)")
        self.device = resolve_device(device)
        self.model = model
        self.schema = schema
        self.history_len = history_len
        self._cache = contextlib.ExitStack()
        self._cache.enter_context(position_bias_cache(model))

    def close(self):
        """Drop the cached position-bias tables."""
        self._cache.close()

    @torch.no_grad()
    def step(self, x: torch.Tensor, forcing_next: Optional[torch.Tensor] = None):
        """x: (B, T_hist, H, W, C_in) -> (y_pred, x_next)."""
        x = x.to(self.device)
        y = self.model(x)
        f = None if forcing_next is None else forcing_next.to(self.device)
        return y, _advance(self.schema, x, y, f, self.history_len)

    def run(self, x0, n_steps: int,
            forcing_provider: Optional[Callable[[int], np.ndarray]] = None,
            on_step: Optional[Callable[[int, np.ndarray], None]] = None) -> List[np.ndarray]:
        """Run n_steps. Returns the predictions as numpy arrays, or streams
        them to on_step(step, y) and returns []. forcing_provider(s) gives
        the (B, 1, H, W, n_dyn) forcing of the next input, or None."""
        x = torch.as_tensor(x0)
        outs: List[np.ndarray] = []
        for s in range(n_steps):
            f = forcing_provider(s + 1) if forcing_provider is not None else None
            y, x = self.step(x, None if f is None else torch.as_tensor(f, dtype=x.dtype))
            y_host = y.float().cpu().numpy()
            if on_step is not None:
                on_step(s, y_host)
            else:
                outs.append(y_host)
        return outs

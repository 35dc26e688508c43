"""Preflight checks run before training starts: port of
credit_tpu/trainers/preflight.py.

Re-implements the reference's preflight suite (reference:
credit/trainers/preflight.py — dataloader RAM estimate :36, first-batch
latency watchdog :109, synthetic forward/backward/optimizer memory probe
:223). The memory probe is the card's own reading: the CUDA allocator's
peak around one real train step, with the training state put back
afterwards.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


def estimate_batch_ram(dataset, batch_size: int, forecast_len: int = 1) -> Dict[str, float]:
    """Host RAM per batch (GB) from one sample's arrays (reference :36)."""
    s = dataset.sample(dataset.history_len, forecast_len)
    nbytes = sum(v.nbytes for v in s.values() if v is not None)
    per_batch = nbytes * batch_size
    out = {"sample_mb": nbytes / 2**20, "batch_gb": per_batch / 2**30}
    logger.info("preflight: ~%.1f MB/sample, ~%.2f GB/batch host RAM",
                out["sample_mb"], out["batch_gb"])
    return out


def first_batch_watchdog(fn, timeout_s: float = 120.0, name: str = "first batch"):
    """Run fn() with a watchdog that logs if it exceeds timeout (reference
    :109 — the reference raises; this warns and keeps going, since the first
    step on a card with a cold build directory compiles the kernels with
    nvcc, which is expected to be slow)."""
    done = threading.Event()

    def bark():
        if not done.wait(timeout_s):
            logger.warning("preflight: %s still not ready after %.0fs "
                           "(likely the CUDA kernels' nvcc build; will keep waiting)",
                           name, timeout_s)

    t = threading.Thread(target=bark, daemon=True)
    t.start()
    t0 = time.time()
    try:
        return fn()
    finally:
        done.set()
        logger.info("preflight: %s took %.1fs", name, time.time() - t0)


def estimate_train_memory(train_step, state, batch) -> Optional[Dict[str, float]]:
    """Peak device memory of one train step, read from the CUDA allocator
    (the reference's synthetic VRAM probe, :223). The step really runs:
    the model's parameters and buffers, the postblock nets', the
    optimizer's tensors, the EMA and the noise generator's state are copied to the host first and put
    back after (the step returns a new state and leaves the given one's
    counts as they were), so training continues from the state it was
    given. None off CUDA."""
    model = state.model
    dev = next(model.parameters()).device
    if dev.type != "cuda":
        logger.info("preflight: device memory probe skipped on %s", dev)
        return None
    saved = [t.detach().cpu() for t in _state_tensors(state)]
    noise = None if state.noise is None else state.noise.get_state()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    train_step(state, batch)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        for t, s in zip(_state_tensors(state), saved):
            t.copy_(s)
    if noise is not None:
        state.noise.set_state(noise)
    out = {"peak_gb": peak / 2**30, "state_gb": base / 2**30}
    logger.info("preflight: device memory peak %.2f GB over one step (%.2f GB before it)",
                out["peak_gb"], out["state_gb"])
    return out


def _state_tensors(state):
    tensors = list(state.model.state_dict().values())
    if state.nets is not None:
        tensors += list(state.nets.state_dict().values())
    for part in state.opt_state.values():  # the moments; MultiSteps' running mean
        if isinstance(part, dict):
            tensors += list(part.values())
    if state.ema_params is not None:
        tensors += list(state.ema_params.values())
    return tensors

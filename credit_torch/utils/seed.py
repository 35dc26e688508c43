"""Deterministic seeding: port of credit_tpu/utils/seed.py (reference:
credit/seed.py:7 seed_everything).

Seeds the host-side generators (python, numpy, torch's default) that
samplers and datasets use and returns the root `torch.Generator`, the
port's counterpart of credit_tpu's root PRNG key. dp-rank divergence
mirrors the reference's two-phase seeding (train_gen2.py:209,230:
identical seed pre-build, +data_rank after)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int, data_rank: int = 0) -> torch.Generator:
    random.seed(seed + data_rank)
    np.random.seed((seed + data_rank) % 2**32)
    torch.manual_seed(seed + data_rank)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed + data_rank)


_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "float64": torch.float64}


def parse_dtype(name):
    """'float32'|'bfloat16'|'float16' -> torch dtype (reference:
    credit/mixed_precision.py:4); anything else is returned as it is."""
    if isinstance(name, str):
        return _DTYPES[name.lower()]
    return name


def fold_generator(*keys: int) -> torch.Generator:
    """A CPU generator seeded from the integer keys in order: the port's
    counterpart of folding them into a jax.random key (fold_in), one
    stream for each key sequence."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))

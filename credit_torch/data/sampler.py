"""Distributed multi-step batch sampler: the port's copy of
credit_tpu/data/sampler.py.

Re-implements the reference's sampler contract
(reference: credit/samplers.py:64 DistributedMultiStepBatchSampler +
credit/parallel/mesh.py:115 data_parallel_coords): a shared-seed permutation
of init times, sliced by data-parallel coordinate only — tensor/domain peers
receive identical batches; each init-time batch drives `num_forecast_steps`
consecutive rollout steps.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class MultiStepSampler:
    """Yields per-epoch lists of init-time index batches for one dp rank."""

    def __init__(self, n_times: int, batch_size: int, forecast_len: int = 1,
                 history_len: int = 1, dp_rank: int = 0, dp_size: int = 1,
                 seed: int = 0, shuffle: bool = True,
                 batches_per_epoch: int = 0, valid_indices=None):
        # valid init times leave room for history before and forecast after;
        # a dataset with gaps (obs sources under missing: skip) passes its
        # own valid_init_indices instead (reference: gen2 datasets drop
        # unmatched init times from the clock, goes.py:1064-1079)
        if valid_indices is not None:
            self.valid = np.asarray(valid_indices, dtype=int)
        else:
            self.valid = np.arange(history_len - 1, n_times - forecast_len - 1)
        self.batch_size = batch_size
        self.forecast_len = forecast_len
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.seed = seed
        self.shuffle = shuffle
        self.batches_per_epoch = batches_per_epoch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = self.valid.copy()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)  # shared seed
            rng.shuffle(idx)
        # slice per dp coordinate only (sampler contract)
        idx = idx[self.dp_rank::self.dp_size]
        n_batches = len(idx) // self.batch_size
        if self.batches_per_epoch:
            n_batches = min(n_batches, self.batches_per_epoch)
        for b in range(n_batches):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def __len__(self) -> int:
        n = len(self.valid) // self.dp_size // self.batch_size
        return min(n, self.batches_per_epoch) if self.batches_per_epoch else n

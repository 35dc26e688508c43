"""Replay buffer for climate-rollout replay training: the port's copy of
credit_tpu/data/replay_buffer.py.

Re-implements the reference's replay training machinery (reference:
credit/replay_buffer.py — ReplayBuffer:77 storing model-predicted states
that are re-sampled as training inputs, TOADataLoader:40 supplying the
matching solar forcing, Trainer:384): keeps a bounded host-side pool of
(state, timestamp) pairs; sampling mixes fresh data with replayed model
states so long climate rollouts stay in-distribution.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int = 128, replay_probability: float = 0.5,
                 seed: int = 0):
        self.capacity = capacity
        self.replay_probability = replay_probability
        self._items: List[Tuple[int, np.ndarray]] = []
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self._items)

    def add(self, t_index: int, state: np.ndarray):
        """Store a model-predicted input state valid at time index t_index."""
        if len(self._items) >= self.capacity:
            self._items.pop(self._rng.randrange(len(self._items)))
        self._items.append((int(t_index), np.asarray(state)))

    def maybe_sample(self) -> Optional[Tuple[int, np.ndarray]]:
        """With replay_probability, return a stored (t_index, state);
        else None (caller uses fresh data)."""
        if self._items and self._rng.random() < self.replay_probability:
            return self._rng.choice(self._items)
        return None

    def make_batch(self, dataset, t_indices, n_steps: int = 1) -> Dict[str, np.ndarray]:
        """Dataset batch where each sample's input may be swapped for a
        replayed model state (targets/forcing always come from data)."""
        batch = dataset.batch(t_indices, n_steps)
        xs = batch["x"].copy()
        for i, t in enumerate(t_indices):
            hit = self.maybe_sample()
            if hit is not None and hit[1].shape == xs[i].shape:
                # re-target the sample to the replayed state's valid time
                s = dataset.sample(hit[0], n_steps)
                xs[i] = hit[1]
                batch["y"][i] = s["y"]
                if "forcing" in batch and s.get("forcing") is not None:
                    batch["forcing"][i] = s["forcing"]
        batch["x"] = xs
        return batch

"""Bred vectors for ensemble initial conditions: port of
credit_tpu/ensemble/bred_vector.py (reference:
credit/ensemble/bred_vector.py:15 BredVector,
generate_bred_vectors[_cycle]:352,424): perturb the IC, run the model
forward alongside the control, rescale the grown difference back to the
seed amplitude, repeat; the final differences become ensemble IC
perturbations.

credit_tpu runs the cycle in a `lax.scan`; here it is a Python loop, so
`step_fn` may be any stateful step (credit_tpu's traced one leaks its
engine's key at three members, ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Callable, List

import torch

from credit_torch.ensemble import noise


def bred_cycle(step_fn: Callable, x_control: torch.Tensor, x_pert: torch.Tensor,
               amplitude: float, n_cycles: int = 3) -> torch.Tensor:
    """One bred vector: run both states n_cycles steps, rescaling the
    perturbation to `amplitude` (RMS over the whole tensor) after each
    step. Returns the final scaled perturbation (same shape as x)."""
    xc, xp = x_control, x_pert
    for _ in range(n_cycles):
        yc = step_fn(xc)
        yp = step_fn(xp)
        diff = yp - yc
        rms = torch.sqrt(torch.mean(diff**2) + 1e-12)
        xc, xp = yc, yc + diff * (amplitude / rms)
    return xp - xc


def generate_bred_vectors(step_fn: Callable, x0: torch.Tensor, generator: torch.Generator,
                          n_members: int, amplitude: float = 0.01,
                          n_cycles: int = 3) -> List[torch.Tensor]:
    """Ensemble of perturbed ICs: x0 + bred vector per member and the
    mirrored x0 - bred vector (reference generate_bred_vectors:352), one
    seed perturbation drawn from `generator` per pair."""
    members = []
    for _ in range((n_members + 1) // 2):
        seed = amplitude * noise.normal(generator, x0.shape, x0.dtype, x0.device)
        bv = bred_cycle(step_fn, x0, x0 + seed, amplitude, n_cycles)
        members.append(x0 + bv)
        if len(members) < n_members:
            members.append(x0 - bv)
    return members[:n_members]

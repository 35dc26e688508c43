"""Ensemble rollout verification harness: port of
credit_tpu/applications/rollout_metrics.py (reference:
credit/applications/rollout_metrics*.py and ensemble_eval.py): build an
ensemble of perturbed initial conditions (gaussian / spherical / bred
vectors, or one IC and a stochastic model), roll every member forward, and
score lat-weighted ensemble metrics (RMSE/ACC of the mean, spread,
spread-skill, CRPS) per lead time against the dataset truth. No netCDF
round-trip: the metrics come back as rows.

Two of credit_tpu's faults are not copied (ROADMAP queue 3): it breeds
through its engine's stateful step inside a traced loop, which leaks the
engine's key and raises at three or more members; and it normalizes the IC
and the forcing before the engine, which normalizes both again. Here the
members are built in the model's normalized space from the IC normalized
once, bred with the engine's step in a Python loop, and rolled out from
there, the forcing normalized by the engine alone.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from credit_torch import resolve_device

logger = logging.getLogger(__name__)


def run_rollout_metrics(conf: dict, n_steps: Optional[int] = None,
                        n_members: Optional[int] = None, perturbation: Optional[str] = None,
                        device="cuda") -> List[Dict]:
    """Rows {step, lead_hours, crps, crps_<var>, rmse, acc, spread,
    spread_skill_ratio} for each of n_steps (predict.forecast_steps, 8)
    leads of an ensemble of n_members (predict.ensemble.size, else
    predict.ensemble_size, 4) from the dataset's first init time, the
    members perturbed by `perturbation` (predict.ensemble.perturbation:
    gaussian, spherical, bred or model) of `amplitude` (0.01, normalized
    units), on one device, CUDA unless the caller asks for the CPU. Draws
    come from generators of the config's seed (per member for gaussian and
    spherical, one for the bred seeds); member m rolls out with the engine
    reseeded to seed * 1000 + m + 1, so a stochastic model's members
    differ."""
    from credit_torch.applications.experiment import _load_engine
    from credit_torch.ensemble import bred_vector
    from credit_torch.ensemble.noise import GaussianNoise, SphericalNoise
    from credit_torch.losses import kcrps
    from credit_torch.metrics import LatWeightedMetrics
    from credit_torch.utils.seed import fold_generator

    dev = resolve_device(device)
    pconf = conf.get("predict", {}) or {}
    econf = pconf.get("ensemble", {}) or {}
    n_steps = n_steps or int(pconf.get("forecast_steps", 8))
    n_members = n_members or int(econf.get("size", pconf.get("ensemble_size", 4)))
    perturbation = perturbation or econf.get("perturbation", "gaussian")
    amplitude = float(econf.get("amplitude", 0.01))
    seed = int(conf.get("seed", 0))

    exp, engine = _load_engine(conf, dev, postblocks=False)
    schema, norm, dataset = exp["schema"], exp["normalizer"], exp["dataset"]
    t0 = dataset.history_len
    x0 = norm.normalize_input(torch.as_tensor(dataset.input_at(t0)[None], device=dev))

    if perturbation == "model":
        # noisy-MODEL ensembles (reference:
        # applications/rollout_metrics_noisy_model.py:333 repeat_interleave):
        # every member starts from the same x0; spread comes from the
        # model's own stochasticity, seeded differently per member below
        members = [x0] * n_members
    elif perturbation == "spherical":
        noise = SphericalNoise(exp["grid"], std=amplitude)
        members = [noise(fold_generator(seed, m), x0) for m in range(n_members)]
    elif perturbation == "bred":
        members = bred_vector.generate_bred_vectors(
            lambda x: engine.step(x)[1], x0, fold_generator(seed), n_members, amplitude)
    else:
        noise = GaussianNoise(std=amplitude)
        members = [noise(fold_generator(seed, m), x0) for m in range(n_members)]

    def forcing(s):
        f = dataset.forcing_at(t0 + s)
        return None if f is None else f[None]

    per_member = []
    for m, xm in enumerate(members):
        engine.reset(batch_size=xm.shape[0], seed=seed * 1000 + m + 1)
        per_member.append(engine.run(xm, n_steps, forcing_provider=forcing, denormalize=True,
                                     x0_normalized=True))
    engine.close()

    metrics = LatWeightedMetrics(exp["grid"], schema.target_names)
    lead = int(conf.get("data", {}).get("lead_time_periods", 6))
    rows = []
    for s in range(n_steps):
        ens = torch.from_numpy(np.stack([per_member[m][s] for m in range(n_members)],
                                        axis=1)).to(dev)  # (1, E, T, H, W, C)
        truth = torch.as_tensor(dataset.target_at(t0 + 1 + s)[None], device=dev)
        out = metrics.ensemble(truth, ens)
        crps_field = kcrps(truth, ens)  # (B, T, H, W, C)
        # per-channel CRPS columns (reference:
        # rollout_metrics_noisy_model.py calculate_crps_per_channel)
        per_var = crps_field.mean(dim=tuple(range(crps_field.dim() - 1))).cpu().tolist()
        row = {"step": s + 1, "lead_hours": (s + 1) * lead,
               "crps": float(crps_field.mean()),
               **{f"crps_{name}": float(v) for name, v in zip(schema.target_names, per_var)},
               **{k: float(v) for k, v in out.items()
                  if k in ("rmse", "acc", "spread", "spread_skill_ratio")}}
        rows.append(row)
        logger.info("rollout-metrics %s", row)
    return rows

"""Hyperparameter-search objective (port of credit_tpu/tuning.py; reference:
the `Objective(BaseObjective)` classes in credit's train/rollout
applications, driven by NCAR's echo-opt / Optuna).

`Objective` runs one training trial from a config with Optuna-suggested
overrides spliced in, reports the validation loss per epoch through the
trainer's pruning hook (`Trainer.optuna_trial`), and returns the optimized
metric. Works with plain Optuna (`study.optimize(Objective(conf), n_trials)`)
and mirrors the echo BaseObjective call contract (`__call__(trial)` ->
{metric: value}). Optuna itself is optional — import errors surface only
when a trial actually runs.
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Any, Dict, Mapping, Optional

logger = logging.getLogger(__name__)


def set_by_path(conf: dict, dotted: str, value) -> None:
    """Set conf['a']['b']['c'] = value for dotted='a.b.c' (the echo-style
    hyperparameter naming convention)."""
    node = conf
    keys = dotted.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def suggest_overrides(trial, space: Mapping[str, Mapping[str, Any]]) -> Dict[str, Any]:
    """Turn an echo-style hyperparameter space into trial suggestions.

    space: {"trainer.learning_rate": {"type": "float", "low": 1e-5,
            "high": 1e-3, "log": True}, "model.dim_head": {"type":
            "categorical", "choices": [16, 32]}, ...}
    """
    out = {}
    for name, spec in space.items():
        kind = spec.get("type", "float")
        if kind == "float":
            out[name] = trial.suggest_float(
                name, float(spec["low"]), float(spec["high"]),
                log=bool(spec.get("log", False)))
        elif kind == "int":
            out[name] = trial.suggest_int(name, int(spec["low"]),
                                          int(spec["high"]))
        elif kind == "categorical":
            out[name] = trial.suggest_categorical(name, list(spec["choices"]))
        else:
            raise ValueError(f"unknown hyperparameter type {kind!r} for {name}")
    return out


def _out_of_memory(e: Exception) -> bool:
    """Whether a trial failed for want of device memory."""
    import torch

    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e)


class Objective:
    """Optuna objective over `credit-torch train` (reference: applications'
    Objective classes; metric default val_loss, per-epoch pruning) on
    `device`, CUDA unless the caller asks for the CPU."""

    def __init__(self, conf: dict, metric: str = "val_loss",
                 space: Optional[Mapping[str, Mapping[str, Any]]] = None,
                 seed: Optional[int] = None, device="cuda"):
        self.conf = conf
        self.metric = metric
        self.space = space or (conf.get("optuna", {}) or {}).get(
            "parameters", {})
        self.seed = seed
        self.device = device

    def __call__(self, trial) -> float:
        from credit_torch import resolve_device
        from credit_torch.applications.experiment import build_experiment
        from credit_torch.trainers.trainer import load_trainer

        conf = copy.deepcopy(self.conf)
        overrides = suggest_overrides(trial, self.space)
        for name, value in overrides.items():
            set_by_path(conf, name, value)
        # one save_loc per trial: training_log.csv is append-mode and
        # checkpoints would clobber across trials otherwise
        num = getattr(trial, "number", 0)
        conf["save_loc"] = os.path.join(
            self.conf.get("save_loc", "./ckpt"), f"trial_{num:04d}")
        logger.info("trial %s overrides: %s", num, overrides)

        dev = resolve_device(self.device)
        exp = build_experiment(conf, dev)
        cls = load_trainer(conf)
        trainer = cls(conf, exp["model"], exp["loss"], exp["valid_loss"],
                      exp["schema"], exp["dataset"], exp["valid_dataset"],
                      save_loc=conf.get("save_loc", "./ckpt"),
                      normalizer=exp["normalizer"], device=dev)
        # per-epoch report + prune (reference: base_trainer trial.report)
        trainer.optuna_trial = trial
        try:
            trainer.fit(None, seed=self.seed if self.seed is not None
                        else int(conf.get("seed", 0)))
        except Exception as e:  # noqa: BLE001 — mirror the reference's
            # resource-pressure pruning so a sweep survives bad configs
            if _out_of_memory(e):
                logger.warning("pruning trial for resource exhaustion: %s", e)
                import optuna

                raise optuna.TrialPruned() from e
            raise
        return self._best_metric(trainer.save_loc)

    def _best_metric(self, save_loc: str) -> float:
        """Best (minimum) value of the optimized metric from the trial's
        training_log.csv (reference optimizes val_loss the same way)."""
        import csv

        key = {"val_loss": "valid_loss", "train_loss": "train_loss"}.get(
            self.metric, self.metric)
        path = os.path.join(save_loc, "training_log.csv")
        with open(path) as f:
            rows = list(csv.DictReader(f))
        vals = [float(r[key]) for r in rows if r.get(key) not in (None, "")]
        if not vals:
            raise RuntimeError(
                f"metric {self.metric!r} ({key}) not found in {path} "
                f"(columns: {sorted(rows[-1]) if rows else []})")
        return float(min(vals))

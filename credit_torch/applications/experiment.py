"""Experiment construction: config -> (schema, grid, model, datasets,
trainer) and the train entry point (port of
credit_tpu/applications/experiment.py).

This is the gen2 application layer (reference:
credit/applications/train_gen2.py:57 main_cli wiring) on one CUDA device:
`run_training(conf)` is `credit train`. The rollout entry point waits for
`output.py` and raises.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import torch

from credit_torch import resolve_device

logger = logging.getLogger(__name__)


def build_data(conf: dict) -> Dict[str, Any]:
    """Model-free data assembly: schema, grid, normalizer, datasets.

    Serves data-only configs (no `model` section) exactly like the
    reference's preprocessing path, which builds datasets without ever
    touching the model (reference: applications/preprocess.py)."""
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.data.local import load_dataset
    from credit_torch.data.normalize import Normalizer
    from credit_torch.grid import grid_from_conf
    from credit_torch.registry import load_custom_objects

    load_custom_objects(conf)
    schema = ChannelSchema.from_config(conf)
    grid = grid_from_conf(conf)

    data = conf.get("data", {}) or {}
    if data.get("mean_path") and data.get("std_path") and os.path.exists(data["mean_path"]):
        normalizer = Normalizer.from_netcdf(schema, data["mean_path"], data["std_path"])
    else:
        normalizer = Normalizer.identity(schema)

    dataset = load_dataset(conf, schema, grid, "train")
    valid = load_dataset(conf, schema, grid, "valid") if conf.get("data_valid") else None
    return {
        "schema": schema, "grid": grid, "normalizer": normalizer,
        "dataset": dataset, "valid_dataset": valid,
    }


def build_experiment(conf: dict, device="cuda") -> Dict[str, Any]:
    """build_data plus the training model (f32 parameters with spectral-norm
    u/v state, zero kernels until the trainer seeds or loads them) on
    `device`, and the training and validation losses."""
    from credit_torch.config import model_channel_check
    from credit_torch.losses import WeightedLoss
    from credit_torch.models import load_model

    dev = resolve_device(device)
    out = build_data(conf)
    model_channel_check(conf, out["schema"])
    out["model"] = load_model(conf, device=dev, sn_state=True)
    out["loss"] = WeightedLoss.from_config(conf, out["grid"])
    out["valid_loss"] = WeightedLoss.from_config(conf, out["grid"], validation=True)
    return out


def prepare_training(conf: dict, seed: Optional[int] = None, device="cuda"):
    """(trainer, state, start_epoch, seed) for `run_training`: the trainer
    of the config's type on `device`, and with trainer.load_weights the
    state read from save_loc's checkpoint, optimizer state included, the
    epochs continuing after the one in its epoch.txt; else no state (fit
    seeds one) and epoch 0. credit_tpu
    restarts the epoch count at 0 on resume, so its sampler repeats the
    first epochs' draws; the port continues it, as the reference's
    start_epoch on reload does."""
    from credit_torch.trainers.trainer import load_trainer

    dev = resolve_device(device)
    exp = build_experiment(conf, dev)
    cls = load_trainer(conf)
    trainer = cls(conf, exp["model"], exp["loss"], exp["valid_loss"], exp["schema"],
                  exp["dataset"], exp["valid_dataset"], save_loc=conf.get("save_loc", "./ckpt"),
                  normalizer=exp["normalizer"], device=dev)
    seed = seed if seed is not None else int(conf.get("seed", 0))
    state, start_epoch = None, 0
    if conf.get("trainer", {}).get("load_weights"):
        state = trainer.load_checkpoint(trainer.init_state(torch.Generator().manual_seed(0)))
        start_epoch = trainer.checkpoint_epoch() + 1
        logger.info("resumed from checkpoint at step %d, epoch %d", state.step, start_epoch)
    return trainer, state, start_epoch, seed


def run_training(conf: dict, seed: Optional[int] = None, device="cuda"):
    """credit train (reference: applications/train_gen2.py) on one device:
    CUDA unless the caller asks for the CPU. Returns the final TrainState."""
    trainer, state, start_epoch, seed = prepare_training(conf, seed, device)
    return trainer.fit(state, seed=seed, start_epoch=start_epoch)


def run_rollout(conf: dict, n_steps: Optional[int] = None, save_dir: Optional[str] = None,
                use_ema: bool = False):
    """credit rollout to netCDF: not ported yet."""
    raise NotImplementedError("run_rollout writes through output.py, which is not ported yet "
                              "(ROADMAP queue 1, item 5); credit_torch.rollout.RolloutEngine "
                              "runs the forecast itself")

"""Experiment construction: config -> (schema, grid, model, datasets,
trainer) and the train entry point (port of
credit_tpu/applications/experiment.py).

This is the gen2 application layer (reference:
credit/applications/train_gen2.py:57 main_cli wiring and
credit/applications/rollout_to_netcdf.py:195 predict) on one CUDA device:
`run_training(conf)` is `credit train`, `run_rollout(conf)` is `credit
rollout` to per-step netCDF files (both first join the process group the
CREDIT_* or torchrun variables describe, parallel.distributed.
maybe_initialize: training on the trainer.parallelism mesh, rollouts each
rank its stride of the init times) (an ensemble's members beside the
control with predict.ensemble_size > 1), and `diff_rollout` compares two
such trees of files. `rollout_metrics.py` scores ensembles without files,
`ensemble_eval.py` the trees run_rollout writes.
"""

from __future__ import annotations

import dataclasses
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
    """credit train (reference: applications/train_gen2.py): CUDA unless
    the caller asks for the CPU. The process group is joined first
    (`maybe_initialize`: a no-op for one process); each rank runs on
    cuda:<local rank>. Returns the final TrainState."""
    from credit_torch.parallel.distributed import maybe_initialize, rank_device

    maybe_initialize(conf, device)
    trainer, state, start_epoch, seed = prepare_training(conf, seed, rank_device(device))
    return trainer.fit(state, seed=seed, start_epoch=start_epoch)


def _inference_model(conf: dict, tensors: Dict[str, torch.Tensor], dev):
    """The inference model (`load_model(conf)`, spectral norm folded) from
    the training model's tensors: each u, v pair run 30 power iterations
    against its kernel in f64 (converge_spectral), then the kernel divided
    by sigma in f32 (fold_spectral), as credit_tpu's rollout folds."""
    from credit_torch.convert_jax import _flatten
    from credit_torch.models import load_model
    from credit_torch.models.spectral_utils import converge_spectral, fold_spectral

    def nest(flat):
        tree = {}
        for name, v in flat.items():
            *path, leaf = name.split(".")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        return tree

    model = load_model(conf, device=dev)
    keys = set(model.state_dict())
    tensors = {k: v for k, v in tensors.items() if not k.startswith("_postblocks.")}
    variables = {"params": nest({k: v for k, v in tensors.items() if k in keys}),
                 "spectral": nest({k: v for k, v in tensors.items() if k not in keys})}
    folded = fold_spectral(converge_spectral(variables))
    model.load_state_dict(_flatten(folded["params"]))
    return model


def _load_engine(conf: dict, dev, use_ema: bool = False, postblocks: bool = True):
    """(exp, engine): build_experiment on `dev`, the weights of save_loc's
    checkpoint (the EMA with use_ema, the trainable postblocks' nets
    included) folded for inference, and a RolloutEngine over them with the
    config's postblocks (the trainer's, built from the same config) or
    none. The checkpoint is the port's `checkpoint/state.pt` (its optimizer
    state is not read), else a credit_tpu (orbax) checkpoint directory
    read through `convert_jax.read_orbax_checkpoint`; where there is
    neither, a fresh seeded init, with a warning."""
    from credit_torch.rollout import RolloutEngine
    from credit_torch.trainers.trainer import TrainState, load_trainer

    exp = build_experiment(conf, dev)
    cls = load_trainer(conf)
    trainer = cls(conf, exp["model"], exp["loss"], exp["valid_loss"], exp["schema"],
                  exp["dataset"], exp["valid_dataset"], save_loc=conf.get("save_loc", "./ckpt"),
                  normalizer=exp["normalizer"], device=dev)
    ckpt = os.path.join(trainer.save_loc, "checkpoint")
    if os.path.exists(os.path.join(ckpt, trainer.CHECKPOINT_FILE)):
        # no noise generator: the train step's draws are no part of a
        # rollout, and a checkpoint written on another kind of device holds
        # another kind of generator's state
        state = dataclasses.replace(TrainState.create(trainer.model, trainer.optimizer,
                                                      ema=trainer.use_ema, nets=trainer.nets),
                                    noise=None)
        state = trainer.load_checkpoint(state, load_optimizer=False)
        logger.info("loaded weights from %s", ckpt)
        tensors = _state_tensors(trainer, state, use_ema)
    elif os.path.exists(os.path.join(ckpt, "_METADATA")):
        tensors = _orbax_tensors(ckpt, conf, dev, use_ema)
        logger.info("loaded credit_tpu weights from %s", ckpt)
    else:
        logger.warning("no checkpoint at %s — rolling out with fresh init", ckpt)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        tensors = _state_tensors(trainer, state, use_ema)
    model = _inference_model(conf, tensors, dev)
    blocks = nets = None
    if postblocks:
        blocks = trainer.train_postblocks
        nets = {k: v for k, v in tensors.items() if k.startswith("_postblocks.")}
    del trainer, tensors, exp["model"]
    engine = RolloutEngine(model, exp["schema"], exp["normalizer"],
                           history_len=int(conf.get("data", {}).get("history_len", 1)) or 1,
                           postblocks=blocks, postblock_params=nets, device=dev)
    return exp, engine


def _state_tensors(trainer, state, use_ema: bool) -> Dict[str, torch.Tensor]:
    """The training model's tensors of `state` (the EMA's parameters with
    use_ema) and its postblock nets' as `_postblocks.<i>.<name>`."""
    if use_ema and state.ema_params is None:
        raise ValueError("use_ema: the trainer keeps no EMA (trainer.use_ema is off)")
    tensors = {k: v.detach() for k, v in trainer.model.state_dict().items()}
    if state.nets is not None:
        tensors.update((f"_postblocks.{k}", v.detach())
                       for k, v in state.nets.state_dict().items())
    if use_ema:
        tensors.update(state.ema_params)
    return tensors


def _orbax_tensors(ckpt: str, conf: dict, dev, use_ema: bool) -> Dict[str, torch.Tensor]:
    """`_state_tensors` of a credit_tpu checkpoint directory: its `params`
    (`ema_params` with use_ema) and `spectral` trees bridged by
    from_jax_variables unfolded, its `params['_postblocks']` by
    postblocks_from_jax."""
    from credit_torch.convert_jax import (from_jax_variables, postblocks_from_jax,
                                          read_orbax_checkpoint)

    trees = read_orbax_checkpoint(ckpt, ("params", "spectral", "ema_params"))
    if use_ema and "ema_params" not in trees:
        raise ValueError(f"use_ema: the checkpoint at {ckpt} holds no ema_params")
    params = trees["ema_params" if use_ema else "params"]
    variables = {"params": params, "spectral": trees.get("spectral", {})}
    tensors = from_jax_variables(variables, conf, device=dev, fold=False)
    if "_postblocks" in params:
        tensors.update(postblocks_from_jax(params["_postblocks"], device=dev))
    return tensors


def run_rollout(conf: dict, n_steps: Optional[int] = None, save_dir: Optional[str] = None,
                use_ema: bool = False, device="cuda"):
    """credit rollout (reference: applications/rollout_to_netcdf.py:195
    predict) on one device, CUDA unless the caller asks for the CPU: the
    weights of save_loc's checkpoint folded for inference (`_load_engine`);
    then for each init time of `predict` an autoregressive rollout through
    RolloutEngine with the config's postblocks, the stateful blocks' states
    carried from step to step and on across the init times and ensemble
    members, as credit_tpu's engine carries them, each step written by the
    engine's writer threads to <save_dir>/<init>/pred_<init>_<FHR>.nc.
    With predict.ensemble_size > 1 each init time also rolls out
    ensemble_size - 1 perturbed members into <save_dir>/<init>_eNN/
    (`ensemble_members`). Returns the written paths."""
    from credit_torch.forecast import strided_for_rank
    from credit_torch.output import save_netcdf_increment
    from credit_torch.parallel.distributed import (maybe_initialize, rank, rank_device,
                                                   world_size)

    maybe_initialize(conf, device)
    dev = resolve_device(rank_device(device))
    pconf = conf.get("predict", {}) or {}
    exp, engine = _load_engine(conf, dev, use_ema)
    n_steps = n_steps or int(pconf.get("forecast_steps", 4))
    save_dir = save_dir or pconf.get("save_forecast") or os.path.join(
        conf.get("save_loc", "."), "forecasts")
    lead_hours = int(conf.get("data", {}).get("lead_time_periods", 6))
    schema, grid = exp["schema"], exp["grid"]
    dataset = exp["dataset"]
    # rank-strided multi-init loop (reference: rollout_to_netcdf.py:266):
    # each rank rolls out its stride of the init list
    inits = strided_for_rank(_resolve_init_indices(pconf, dataset), rank(), world_size())
    written = []
    for t0, label in inits:
        x0 = dataset.input_at(t0)[None]

        def forcing(s, t0=t0):
            f = dataset.forcing_at(t0 + s) if hasattr(dataset, "forcing_at") else None
            return None if f is None else f[None]

        for suffix, xm, normalized in [("", x0, False)] + ensemble_members(engine, x0, pconf, t0):
            def writer(step, y, label=label + suffix):
                written.append(save_netcdf_increment(y[0], schema, grid, save_dir, label,
                                                     (step + 1) * lead_hours))

            engine.run(xm, n_steps, forcing_provider=forcing, on_step=writer,
                       x0_normalized=normalized)
    engine.close()
    logger.info("wrote %d forecast files (%d inits x %d members) to %s", len(written),
                len(inits), int(pconf.get("ensemble_size", 1) or 1), save_dir)
    return written


def ensemble_members(engine, x0, pconf: dict, t0: int):
    """The perturbed members of one init time for predict.ensemble_size E,
    [(suffix, initial state, whether it is normalized)] for members 1..E-1,
    named _e01.. as credit_tpu names them (none when E <= 1).

    gaussian (the default): the physical IC plus perturbation_std (1e-3)
    times a normal draw per member from the generator of (predict.seed,
    t0, member). bred: E - 1 bred vectors of amplitude perturbation_std
    grown by bred_cycles (3) engine steps from fresh states
    (`RolloutEngine.fresh_step`, as credit_tpu's pure step), their seed
    perturbations drawn from the generator of (predict.seed, t0), mirrored
    in pairs. The port breeds in the model's normalized space, where the
    engine runs; credit_tpu breeds its normalized-space model on the
    physical IC and adds the bred difference to the physical IC (ROADMAP
    queue 3). With the identity normalizer the two agree."""
    from credit_torch.ensemble import bred_vector
    from credit_torch.ensemble.noise import GaussianNoise
    from credit_torch.utils.seed import fold_generator

    ens = int(pconf.get("ensemble_size", 1) or 1)
    std = float(pconf.get("perturbation_std", 1e-3))
    seed = int(pconf.get("seed", 0))
    if ens <= 1:
        return []
    x = torch.as_tensor(x0).to(engine.device)
    if pconf.get("perturbation", "gaussian") == "bred":
        if engine.normalizer is not None:
            x = engine.normalizer.normalize_input(x)
        ics = bred_vector.generate_bred_vectors(
            lambda s: engine.fresh_step(s)[1], x, fold_generator(seed, t0), ens - 1,
            amplitude=std, n_cycles=int(pconf.get("bred_cycles", 3)))
        return [(f"_e{m + 1:02d}", ic, True) for m, ic in enumerate(ics)]
    g = GaussianNoise(std)
    return [(f"_e{m:02d}", g(fold_generator(seed, t0, m), x), False) for m in range(1, ens)]


def diff_rollout(paths, ref, rtol: float = 2e-4, atol: float = 2e-4):
    """Compare produced rollout netCDFs against reference files (reference:
    credit_tpu/applications/experiment.py diff_rollout). `ref` is a
    directory mirroring the output tree (matched by relative path, falling
    back to basename) or a single file when one path was written. Returns a
    report list; entry['ok'] per file, per-variable max-abs/rel errors.
    atol is applied RELATIVE to each variable's reference max-abs."""
    import numpy as np

    from credit_torch.utils.ncio import open_dataset

    paths = list(paths)
    report = []
    for p in paths:
        if os.path.isdir(ref):
            cand = [os.path.join(ref, os.path.join(
                os.path.basename(os.path.dirname(p)), os.path.basename(p))),
                os.path.join(ref, os.path.basename(p))]
            rp = next((c for c in cand if os.path.exists(c)), None)
        elif len(paths) == 1:
            rp = ref
        else:
            # several outputs against one reference file: only the output
            # whose basename matches is compared
            rp = ref if (os.path.exists(ref) and os.path.basename(p)
                         == os.path.basename(ref)) else None
        if rp is None or not os.path.exists(rp):
            report.append({"path": p, "ref": None, "ok": False,
                           "error": "no matching reference file"})
            continue
        ours, theirs = open_dataset(p), open_dataset(rp)
        entry = {"path": p, "ref": rp, "vars": {}, "ok": True}
        for name in theirs.keys():
            if name not in ours:
                entry["vars"][name] = {"missing": True}
                entry["ok"] = False
                continue
            a = np.asarray(ours[name].values, np.float64)
            b = np.asarray(theirs[name].values, np.float64)
            if a.shape != b.shape:
                entry["vars"][name] = {"shape": (a.shape, b.shape)}
                entry["ok"] = False
                continue
            scale = np.abs(b).max() or 1.0
            err = np.abs(a - b).max()
            ok = bool(err <= atol * scale + rtol * scale)
            entry["vars"][name] = {"max_abs": float(err),
                                   "rel": float(err / scale), "ok": ok}
            entry["ok"] = entry["ok"] and ok
        report.append(entry)
    return report


def _resolve_init_indices(pconf: dict, dataset):
    """-> [(clock_index, label)]: predict.forecasts datetimes when the
    dataset has a datetime clock (reference: forecast.py:39
    generate_forecasts), explicit integer indices, or the single default
    init at history_len."""
    from credit_torch.forecast import generate_forecasts

    fc = pconf.get("forecasts")
    if fc is not None and hasattr(dataset, "index_of"):
        out = []
        for when in generate_forecasts(pconf):
            idx = dataset.index_of(when.isoformat())
            out.append((idx, when.strftime("%Y-%m-%dT%HZ")))
        return out
    if isinstance(fc, list) and fc and isinstance(fc[0], int):
        return [(int(i), f"init{int(i):04d}") for i in fc]
    if fc is not None and not hasattr(dataset, "index_of"):
        # integer-clock datasets: expand duration x start_hours as offsets
        base = dataset.history_len
        n = len(generate_forecasts(pconf))
        return [(base + i, f"init{base + i:04d}")
                for i in range(n) if base + i < len(dataset) - 1]
    t0 = dataset.history_len
    return [(t0, pconf.get("init_label", f"init{t0:04d}"))]

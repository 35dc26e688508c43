"""CLI: credit-torch {init,train,rollout,realtime,preprocess,convert,metrics,
plot,submit,ensemble-eval,rollout-metrics,summary,tune,convert-checkpoint,
benchmark,solar,serve} (port of credit_tpu/cli/main.py).

The same subcommands, arguments and exit codes as credit-tpu (CREDIT
credit/cli/_parser.py:32-123, 357). The commands that run a model take
`--device` (cuda by default; `--device cpu` runs the plain PyTorch
versions). `submit` writes PBS and SLURM scripts that start one process
per GPU with the CREDIT_* variables `parallel.distributed.maybe_initialize`
reads; credit-tpu's `--scheduler gcloud` launches TPU VMs and is refused
(exit 2). `convert-checkpoint` writes the port's own checkpoint,
`save_loc/checkpoint/state.pt`.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

logger = logging.getLogger("credit_torch")

TEMPLATE = """\
save_loc: ./experiment
seed: 1000

data:
  source:
    ERA5:
      dataset_type: synthetic   # synthetic | local (+ zarr sources when installed)
      levels: [0., 1., 2., 3.]
      variables:
        prognostic:
          vars_3D: ['U', 'V', 'T', 'Q']
          vars_2D: ['SP', 'VAR_2T']
        dynamic_forcing:
          vars_2D: ['tsi']
        static:
          vars_2D: ['lsm']
        diagnostic:
          vars_2D: ['total_precipitation']
  history_len: 1
  forecast_len: 1
  lead_time_periods: 6

trainer:
  type: era5-v2
  learning_rate: 1.0e-4
  weight_decay: 0.0
  train_batch_size: 2
  batches_per_epoch: 10
  num_epoch: 2
  grad_max_norm: 1.0
  use_ema: false
  parallelism:
    data: none
    tensor: 1
    domain: 1

model:
  type: crossformer
  frames: 1
  image_height: 64
  image_width: 128
  levels: 4
  channels: 4
  surface_channels: 2
  input_only_channels: 2
  output_only_channels: 1
  dim: [32, 64, 128, 256]
  depth: [1, 1, 2, 1]
  global_window_size: [4, 2, 2, 1]
  local_window_size: 2
  cross_embed_kernel_sizes: [[4, 8], [2, 4], [2, 4], [2, 4]]
  cross_embed_strides: [2, 2, 2, 2]
  use_spectral_norm: true
  interp: true
  padding_conf: {activate: true, mode: earth, pad_lat: [16, 16], pad_lon: [0, 0]}

loss:
  training_loss: mse
  use_latitude_weights: true

predict:
  forecast_steps: 4
"""


def _load(args):
    from credit_torch.config import load_config

    return load_config(args.config)


def cmd_init(args):
    path = args.config or "config.yml"
    if os.path.exists(path) and not args.force:
        print(f"{path} exists; use --force to overwrite", file=sys.stderr)
        return 1
    with open(path, "w") as f:
        f.write(TEMPLATE)
    print(f"wrote template config to {path}")
    return 0


def cmd_train(args):
    from credit_torch.applications import run_training
    from credit_torch.parallel.distributed import maybe_initialize

    conf = _load(args)
    # join the process group before any device use (CREDIT
    # credit/distributed.py:32 setup); a no-op for one process
    maybe_initialize(conf, args.device)
    if args.profile:
        import torch

        trace_dir = os.path.join(conf.get("save_loc", "."), "profile")
        os.makedirs(trace_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            run_training(conf, seed=args.seed, device=args.device)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path} (a chrome trace: chrome://tracing "
              f"or Perfetto)")
        return 0
    run_training(conf, seed=args.seed, device=args.device)
    return 0


def cmd_rollout(args):
    from credit_torch.applications import run_rollout
    from credit_torch.parallel.distributed import maybe_initialize

    conf = _load(args)
    maybe_initialize(conf, args.device)
    paths = run_rollout(conf, n_steps=args.steps, save_dir=args.out, use_ema=args.ema,
                        device=args.device)
    for p in paths:
        print(p)
    if getattr(args, "diff_against", None):
        # checkpoint parity acceptance: compare the netCDF files against a
        # reference rollout's and fail loudly
        from credit_torch.applications.experiment import diff_rollout

        report = diff_rollout(paths, args.diff_against, rtol=args.diff_rtol,
                              atol=args.diff_atol)
        worst = 0.0
        ok = True
        for e in report:
            ok = ok and e["ok"]
            tag = "OK  " if e["ok"] else "FAIL"
            print(f"[diff {tag}] {e['path']} vs {e.get('ref')}")
            for name, v in sorted(e.get("vars", {}).items()):
                if "rel" in v:
                    worst = max(worst, v["rel"])
                    print(f"    {name:24s} max_abs={v['max_abs']:.3e} "
                          f"rel={v['rel']:.3e} {'' if v['ok'] else '  <-- OVER'}")
                else:
                    print(f"    {name:24s} {v}")
        print(f"[diff] worst relative error {worst:.3e} "
              f"(rtol={args.diff_rtol}, atol={args.diff_atol}*scale) -> "
              f"{'PASS' if ok else 'FAIL'}")
        return 0 if ok else 1
    return 0


def cmd_realtime(args):
    """Realtime NWP-initialized rollout (CREDIT rollout_realtime.py +
    credit/nwp.py build_GFS_init)."""
    from credit_torch.applications.realtime import load_fields_npz, run_realtime

    conf = _load(args)
    fields = coords = None
    if args.fields:
        fields, coords = load_fields_npz(args.fields)
    paths = run_realtime(conf, n_steps=args.steps, save_dir=args.out, fields=fields,
                         coords=coords, device=args.device)
    for p in paths:
        print(p)
    return 0


def cmd_preprocess(args):
    """Fit per-channel normalization statistics over training samples and
    write them beside the checkpoint (CREDIT credit preprocess,
    applications/preprocess.py)."""
    import numpy as np

    from credit_torch.applications.experiment import build_data
    from credit_torch.config import load_config

    # data-only configs (no `model` section) are valid here, as in CREDIT,
    # whose preprocess never touches the model
    conf = load_config(args.config, require_model=False)
    exp = build_data(conf)
    ds, schema = exp["dataset"], exp["schema"]
    n = min(len(ds) - 2, args.samples)
    xs, ys = [], []
    for t in range(ds.history_len, ds.history_len + n):
        s = ds.sample(t, 1)
        xs.append(s["x"].reshape(-1, schema.n_input))
        ys.append(s["y"].reshape(-1, schema.n_target))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    save_loc = conf.get("save_loc", ".")
    os.makedirs(save_loc, exist_ok=True)
    out = os.path.join(save_loc, "normalization.npz")
    np.savez(out, input_mean=x.mean(0), input_std=x.std(0) + 1e-8,
             target_mean=y.mean(0), target_std=y.std(0) + 1e-8)
    if args.scaler:
        # bridgescaler-style distribution scalers (CREDIT
        # applications/preprocess.py fits DQuantile/DMinMax over workers;
        # here per channel over the sampled rows)
        sout = os.path.join(save_loc, "scaler.npz")
        if args.scaler == "quantile":
            qs = np.linspace(0, 100, int(args.quantiles))
            np.savez(sout, quantiles=np.stack(
                [np.percentile(x[:, c], qs) for c in range(x.shape[1])]))
        elif args.scaler == "minmax":
            np.savez(sout, min=x.min(0), max=x.max(0) + 1e-8)
        else:
            np.savez(sout, mean=x.mean(0), std=x.std(0) + 1e-8)
        print(f"wrote {sout} ({args.scaler})")
    schema.save(save_loc)
    print(f"wrote {out} (from {n} samples)")
    return 0


def cmd_convert(args):
    """Legacy gen1 config -> the gen2 nested schema (CREDIT credit convert)."""
    import yaml

    from credit_torch.config import convert_legacy

    with open(args.config) as f:
        conf = yaml.safe_load(f)
    conv = convert_legacy(conf)
    out = args.out or args.config.replace(".yml", "_gen2.yml")
    with open(out, "w") as f:
        yaml.safe_dump(conv, f, sort_keys=False)
    print(f"wrote {out}")
    return 0


def cmd_metrics(args):
    """Latitude-weighted metrics of forecast files against the dataset's
    truth (on the host)."""
    import numpy as np
    import torch

    from credit_torch.applications.experiment import build_data
    from credit_torch.metrics import LatWeightedMetrics
    from credit_torch.utils.ncio import open_dataset

    conf = _load(args)
    exp = build_data(conf)
    metrics = LatWeightedMetrics(exp["grid"], exp["schema"].target_names)
    rows = []
    for path in args.files:
        ds = open_dataset(path)
        step = int(float(ds.attrs.get("lead_hours", 6))) // int(
            conf.get("data", {}).get("lead_time_periods", 6))
        truth = exp["dataset"].target_at(exp["dataset"].history_len + step)
        flat = np.stack([
            (np.asarray(ds[e.name.rpartition("_L")[0] or e.name].values)
             [:, int(e.name.rpartition("_L")[2])] if "_L" in e.name
             and e.name.rpartition("_L")[2].isdigit()
             else np.asarray(ds[e.name].values))
            for e in exp["schema"].target_entries
        ], axis=-1)
        out = metrics(torch.from_numpy(truth[None].astype(np.float32)),
                      torch.from_numpy(flat[None].astype(np.float32)))
        rows.append({"file": os.path.basename(path),
                     **{k: float(v) for k, v in out.items() if k in ("rmse", "mae", "acc")}})
    print(json.dumps(rows, indent=1))
    return 0


def cmd_ensemble_eval(args):
    """Offline ensemble verification of a saved rollout tree (CREDIT
    applications/ensemble_eval.py: spread-error, binned spread-skill,
    zonal and div/rot spectra from netCDF files, no model run)."""
    from credit_torch.applications.ensemble_eval import run_ensemble_eval

    run_ensemble_eval(_load(args), args.root, n_bins=args.bins, out_path=args.out,
                      device=args.device)
    return 0


def cmd_plot(args):
    """A forecast field's map, or an animation across forecast files (CREDIT
    credit plot, cli/_plot.py + credit/animation.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from credit_torch.utils.ncio import open_dataset
    from credit_torch.visualization import (colormap_extend, convert_for_display, draw_field,
                                            panel_grid, pick_colormap, round_range,
                                            variable_range)

    def field(path, var=None):
        ds = open_dataset(path)
        var = var or next(iter(ds.keys()))
        arr = np.asarray(ds[var].values)
        while arr.ndim > 2:
            arr = arr[0]
        return var, arr

    files = sorted(args.files)
    if len(files) > 1 or args.animate:
        from matplotlib import animation as manim

        var, first = field(files[0], args.var)
        frames = [convert_for_display(var, field(f, var)[1])[0] for f in files]
        units = convert_for_display(var, first)[1]
        vmin, vmax = round_range(*variable_range(np.stack(frames)))
        fig, ax = plt.subplots(figsize=(8, 4))
        im = ax.imshow(frames[0], aspect="auto", cmap=pick_colormap(var), vmin=vmin, vmax=vmax)
        fig.colorbar(im, ax=ax, extend=colormap_extend(
            (min(f.min() for f in frames), max(f.max() for f in frames)), (vmin, vmax)))
        title = ax.set_title("")
        label = f"{var} [{units}]" if units else var

        def update(i):
            im.set_data(frames[i])
            title.set_text(f"{label} — {os.path.basename(files[i])}")
            return [im, title]

        ani = manim.FuncAnimation(fig, update, frames=len(frames))
        out = args.out or (os.path.splitext(files[0])[0] + f"_{var}.gif")
        ani.save(out, writer=manim.PillowWriter(fps=args.fps))
        print(out)
        return 0
    ds = open_dataset(files[0])
    # up to 6 variables in panels (CREDIT visualization_tools.figure_panel_planner)
    names = [args.var] if args.var else list(ds.keys())[:6]
    rows, cols = panel_grid(len(names))
    fig, axes = plt.subplots(rows, cols, figsize=(6.5 * cols, 3.5 * rows), squeeze=False)
    for i, name in enumerate(names):
        arr = np.asarray(ds[name].values)
        while arr.ndim > 2:
            arr = arr[0]
        ax = axes[i // cols][i % cols]
        im = draw_field(ax, arr, name)
        fig.colorbar(im, ax=ax)
    for j in range(len(names), rows * cols):
        axes[j // cols][j % cols].axis("off")
    var = names[0]
    out = args.out or (os.path.splitext(files[0])[0] + f"_{var}.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    print(out)
    return 0


def cmd_submit(args):
    """A multi-node launch script (CREDIT credit submit, cli/_submit.py +
    pbs.py/slurm.py): one process per GPU, each told its rank by the
    CREDIT_* variables, and with --resubmit N a chain of N dependent
    restarts that resume from the checkpoint."""
    if args.scheduler == "gcloud":
        print("--scheduler gcloud launches credit-tpu on TPU VMs; credit-torch runs on GPU "
              "nodes: use --scheduler slurm or pbs", file=sys.stderr)
        return 2
    conf = _load(args)
    name = conf.get("save_loc", "credit-torch-job").strip("./").replace("/", "-") \
        or "credit-torch"
    gpus = args.gpus_per_node
    cmd = f"python -m credit_torch.cli train {args.config}"
    if args.scheduler == "pbs":
        script = f"""#!/bin/bash
#PBS -N {name}
#PBS -l select={args.nodes}:ncpus=64:ngpus={gpus}
#PBS -l walltime=12:00:00
#PBS -j oe
cd $PBS_O_WORKDIR
# multi-node rendezvous: the first node of the list hosts process 0; each
# node runs one process per GPU, ranks node-major
NODES=($(sort -u $PBS_NODEFILE))
export CREDIT_NUM_PROCESSES=$(( ${{#NODES[@]}} * {gpus} ))
export CREDIT_COORDINATOR=${{NODES[0]}}:29500
for i in "${{!NODES[@]}}"; do
  for g in $(seq 0 {gpus - 1}); do
    ssh ${{NODES[$i]}} "cd $PBS_O_WORKDIR && CREDIT_NUM_PROCESSES=$CREDIT_NUM_PROCESSES \\
CREDIT_COORDINATOR=$CREDIT_COORDINATOR CREDIT_PROCESS_ID=$(( i * {gpus} + g )) \\
LOCAL_RANK=$g {cmd}" &
  done
done
wait
"""
    else:
        script = f"""#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --nodes={args.nodes}
#SBATCH --ntasks-per-node={gpus}
#SBATCH --gpus-per-node={gpus}
#SBATCH --exclusive
export CREDIT_NUM_PROCESSES=$SLURM_NTASKS
export CREDIT_COORDINATOR=$(scontrol show hostnames $SLURM_JOB_NODELIST | head -1):29500
srun bash -c 'CREDIT_PROCESS_ID=$SLURM_PROCID LOCAL_RANK=$SLURM_LOCALID {cmd}'
"""
    out = args.out or f"launch_{name}.sh"
    with open(out, "w") as f:
        f.write(script)
    os.chmod(out, 0o755)
    print(out)
    if getattr(args, "resubmit", 0) > 0:
        # chained restarts (CREDIT credit submit --resubmit N, cli/_submit.py:628
        # _compute_chain): restart i waits for restart i-1 and resumes from
        # its checkpoint
        n = args.resubmit
        if args.scheduler == "pbs":
            chain = (f"#!/bin/bash\nPREV=$(qsub {out})\necho $PREV\n"
                     f"for i in $(seq {n}); do\n"
                     f"  PREV=$(qsub -W depend=afterok:$PREV {out})\n"
                     f"  echo $PREV\ndone\n")
        else:
            chain = (f"#!/bin/bash\nPREV=$(sbatch --parsable {out})\n"
                     f"echo $PREV\nfor i in $(seq {n}); do\n"
                     f"  PREV=$(sbatch --parsable --dependency=afterok:$PREV {out})\n"
                     f"  echo $PREV\ndone\n")
        chain_out = os.path.splitext(out)[0] + "_chain.sh"
        with open(chain_out, "w") as f:
            f.write(chain)
        os.chmod(chain_out, 0o755)
        print(chain_out)
    return 0


def cmd_benchmark(args):
    if getattr(args, "halo", False):
        from credit_torch.applications.benchmark import benchmark_halo

        print(json.dumps(benchmark_halo(steps=args.steps, device=args.device), indent=1))
        return 0
    from credit_torch.applications.benchmark import benchmark_parallelism

    combos = None
    if args.combos:
        combos = [tuple(int(v) for v in c.split("x")) for c in args.combos.split(",")]
    rows = benchmark_parallelism(_load(args), combos=combos, steps=args.steps,
                                 device=args.device)
    print(json.dumps(rows, indent=1))
    return 0


def cmd_rollout_metrics(args):
    """Ensemble rollout verification (CREDIT rollout_metrics apps)."""
    from credit_torch.applications.rollout_metrics import run_rollout_metrics

    rows = run_rollout_metrics(_load(args), n_steps=args.steps, n_members=args.members,
                               perturbation=args.perturbation, device=args.device)
    print(json.dumps(rows, indent=1))
    return 0


def cmd_solar(args):
    """Accumulated TOA solar radiation (the TSI forcing) files over a date
    range (CREDIT applications/calc_global_solar.py, MPI rank-strided; here
    --rank/--world stride the times the same way, one process a task)."""
    import datetime as _dt

    import numpy as np

    from credit_torch.data.timeclock import TimeClock, parse_timestep
    from credit_torch.data.tisr import _doy_hour
    from credit_torch.physics.solar import tisr_accumulated
    from credit_torch.utils.ncio import Dataset, Variable

    lat = np.linspace(90.0, -90.0, args.nlat)
    lon = np.arange(args.nlon) * (360.0 / args.nlon)
    clock = TimeClock(args.start, args.end, args.step, args.calendar,
                      history_len=1, num_forecast_steps=0)
    times = list(clock.all_times)
    os.makedirs(args.out, exist_ok=True)
    # the accumulation period from the parser the clock uses: '30min', '1d'
    # accumulate over the requested cadence, not an hour
    period = float(parse_timestep(args.step) / np.timedelta64(1, "s")) / 3600.0
    written = []
    for i in range(args.rank, len(times), args.world):
        t = times[i]
        doy, hour = _doy_hour(t)
        when = _dt.datetime(2001, 1, 1) + _dt.timedelta(days=doy - 1, hours=hour)
        field = np.asarray(tisr_accumulated(lat, lon, when, period, tsi=args.tsi), np.float32)
        stamp = str(t).replace(" ", "_").replace(":", "")
        path = os.path.join(args.out, f"{args.var}_{stamp}.nc")
        Dataset({args.var: Variable(("time", "lat", "lon"), field[None],
                                    {"units": "J m**-2",
                                     "long_name": "TOA incident solar radiation (accumulated)"})},
                coords={"time": np.array([float(i)]), "lat": lat, "lon": lon},
                attrs={"calendar": args.calendar}).to_netcdf(path)
        written.append(path)
    print(json.dumps({"files": len(written), "rank": args.rank, "world": args.world}))
    return 0


def cmd_tune(args):
    """Optuna hyperparameter search over `train` (CREDIT's echo/Optuna
    Objective classes; the space from the config's optuna.parameters)."""
    try:
        import optuna
    except ImportError:
        print("optuna is not installed; `pip install optuna` to run "
              "hyperparameter search (the Objective class in "
              "credit_torch/tuning.py also works with any echo-compatible "
              "driver)", file=sys.stderr)
        return 2
    from credit_torch.tuning import Objective

    conf = _load(args)
    study = optuna.create_study(
        direction="minimize", study_name=args.study, storage=args.storage,
        load_if_exists=bool(args.storage), pruner=optuna.pruners.MedianPruner())
    study.optimize(Objective(conf, metric=args.metric, device=args.device),
                   n_trials=args.trials)
    best = study.best_trial
    print(json.dumps({"best_value": best.value, "params": best.params}))
    return 0


def parameter_rows(conf: dict):
    """[(name, shape, count)] of the model's parameters, its blocks'
    paths joined with '/' as credit_tpu's summary names them; the model is
    built on the meta device, so nothing is allocated."""
    from credit_torch.models import load_model

    model = load_model(conf, device="meta")
    return [(name.replace(".", "/"), tuple(p.shape), p.numel())
            for name, p in model.named_parameters()]


def cmd_summary(args):
    """The model's parameter counts by block (CREDIT applications/model_summary.py)."""
    from credit_torch.data.channels import ChannelSchema

    conf = _load(args)
    schema = ChannelSchema.from_config(conf)
    rows = parameter_rows(conf)
    total = sum(n for _, _, n in rows)
    print(f"model: {conf.get('model', {}).get('type')}  input channels: {schema.n_input}  "
          f"target channels: {schema.n_target}")
    if args.verbose:
        for name, shape, n in rows:
            print(f"  {name:70s} {str(shape):22s} {n:>12,}")
    by_block = {}
    for name, _, n in rows:
        by_block[name.split("/")[0]] = by_block.get(name.split("/")[0], 0) + n
    for blk, n in sorted(by_block.items(), key=lambda kv: -kv[1]):
        print(f"  {blk:30s} {n:>14,}  ({100 * n / total:.1f}%)")
    print(f"total parameters: {total:,} ({total / 1e6:.2f}M)")
    return 0


def cmd_convert_checkpoint(args):
    """A CREDIT PyTorch checkpoint (.pt), or with --dry-run-manifest a
    state dict synthesized in a published checkpoint's layout, converted
    into the port (`convert_torch`), loaded strictly into the model on
    --device, and written as the port's checkpoint (`state.pt` holding the
    model's tensors and step 0) in --out, else save_loc/checkpoint."""
    import torch

    from credit_torch import resolve_device
    from credit_torch.convert_torch import convert_checkpoint, load_torch_checkpoint
    from credit_torch.models import load_model
    from credit_torch.trainers.trainer import Trainer

    conf = _load(args)
    manifest = getattr(args, "dry_run_manifest", None)
    if manifest:
        # the published checkpoint's key/shape layout, synthesized values
        from credit_torch.manifests import MANIFEST_MODEL_CONF, synthesize_state_dict

        conf = {**conf, "model": dict(MANIFEST_MODEL_CONF[manifest])}
        sd = synthesize_state_dict(manifest)
    else:
        sd = load_torch_checkpoint(args.torch_checkpoint)
    tensors = convert_checkpoint(sd, conf, strict=not args.lenient)
    model = load_model(conf, device=resolve_device(args.device), sn_state=True)
    model.load_state_dict(tensors)  # strict: every key of the port's model
    out = os.path.abspath(args.out or os.path.join(conf.get("save_loc", "."), "checkpoint"))
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, Trainer.CHECKPOINT_FILE)
    torch.save({"model": tensors, "step": 0}, path + ".tmp")
    os.replace(path + ".tmp", path)
    n = sum(p.numel() for p in model.parameters())
    logger.info("%s: %d tensors, %d parameters (%.2fM)", path, len(tensors), n, n / 1e6)
    print(out)
    return 0


def cmd_serve(args):
    from credit_torch.serve import serve

    serve(_load(args), host=args.host, port=args.port, device=args.device)
    return 0


def _device(sp):
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain PyTorch versions)")


def build_parser():
    p = argparse.ArgumentParser("credit-torch",
                                description="CREDIT AI-NWP on PyTorch and CUDA (H100)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("init", help="write a template config")
    sp.add_argument("config", nargs="?")
    sp.add_argument("--force", action="store_true")
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("train", help="train a model")
    sp.add_argument("config")
    sp.add_argument("--seed", type=int, default=None)
    sp.add_argument("--profile", action="store_true",
                    help="write a torch.profiler chrome trace of the run")
    _device(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("rollout", help="autoregressive forecast to netCDF")
    sp.add_argument("config")
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--out", default=None)
    sp.add_argument("--ema", action="store_true")
    sp.add_argument("--diff-against", default=None,
                    help="reference netCDF file/dir: per-variable allclose "
                         "report, exit 1 on mismatch")
    sp.add_argument("--diff-rtol", type=float, default=2e-4)
    sp.add_argument("--diff-atol", type=float, default=2e-4)
    _device(sp)
    sp.set_defaults(fn=cmd_rollout)

    sp = sub.add_parser("realtime", help="NWP-initialized realtime forecast to netCDF")
    sp.add_argument("config")
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--out", default=None)
    sp.add_argument("--fields", default=None,
                    help="npz of decoded NWP fields (lat/lon/pressure + vars)")
    _device(sp)
    sp.set_defaults(fn=cmd_realtime)

    sp = sub.add_parser("preprocess", help="fit normalization stats")
    sp.add_argument("config")
    sp.add_argument("--samples", type=int, default=32)
    sp.add_argument("--scaler", default=None, choices=["quantile", "standard", "minmax"],
                    help="also fit a bridgescaler-style scaler.npz")
    sp.add_argument("--quantiles", type=int, default=101)
    sp.set_defaults(fn=cmd_preprocess)

    sp = sub.add_parser("convert", help="convert legacy gen1 config to gen2")
    sp.add_argument("config")
    sp.add_argument("--out", default=None)
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser("metrics", help="score forecast files")
    sp.add_argument("config")
    sp.add_argument("files", nargs="+")
    sp.set_defaults(fn=cmd_metrics)

    sp = sub.add_parser("plot", help="plot a forecast field (or animate many)")
    sp.add_argument("files", nargs="+")
    sp.add_argument("--var", default=None)
    sp.add_argument("--out", default=None)
    sp.add_argument("--animate", action="store_true")
    sp.add_argument("--fps", type=int, default=4)
    sp.set_defaults(fn=cmd_plot)

    sp = sub.add_parser("submit", help="generate a multi-node GPU launch script")
    sp.add_argument("config")
    sp.add_argument("--scheduler", choices=["gcloud", "slurm", "pbs"], default="slurm",
                    help="slurm or pbs (gcloud, credit-tpu's TPU-VM launcher, is refused)")
    sp.add_argument("--nodes", type=int, default=1)
    sp.add_argument("--gpus-per-node", type=int, default=1,
                    help="processes (one a GPU) started on each node")
    sp.add_argument("--out", default=None)
    sp.add_argument("--resubmit", type=int, default=0,
                    help="also write a chain script submitting N dependent "
                         "restarts (afterok) that resume from checkpoint")
    sp.set_defaults(fn=cmd_submit)

    sp = sub.add_parser("ensemble-eval", help="offline ensemble verification of saved rollouts")
    sp.add_argument("config")
    sp.add_argument("root", help="rollout output tree (init dirs + _eNN members)")
    sp.add_argument("--bins", type=int, default=6)
    sp.add_argument("--out", default=None)
    _device(sp)
    sp.set_defaults(fn=cmd_ensemble_eval)

    sp = sub.add_parser("rollout-metrics",
                        help="noisy-IC ensemble rollout + verification metrics")
    sp.add_argument("config")
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--members", type=int, default=None)
    sp.add_argument("--perturbation", choices=["gaussian", "spherical", "bred", "model"],
                    default=None)
    _device(sp)
    sp.set_defaults(fn=cmd_rollout_metrics)

    sp = sub.add_parser("summary", help="model parameter summary")
    sp.add_argument("config")
    sp.add_argument("-v", "--verbose", action="store_true")
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("tune", help="optuna hyperparameter search "
                        "(space: config optuna.parameters)")
    sp.add_argument("config")
    sp.add_argument("--trials", type=int, default=10)
    sp.add_argument("--metric", default="val_loss")
    sp.add_argument("--study", default="credit-torch")
    sp.add_argument("--storage", default=None,
                    help="optuna storage URL (sqlite:///study.db) for "
                    "resumable/parallel sweeps")
    _device(sp)
    sp.set_defaults(fn=cmd_tune)

    sp = sub.add_parser("convert-checkpoint",
                        help="CREDIT torch .pt checkpoint -> the port's checkpoint")
    sp.add_argument("config")
    sp.add_argument("torch_checkpoint", nargs="?", default=None)
    sp.add_argument("--out", default=None)
    sp.add_argument("--lenient", action="store_true")
    sp.add_argument("--dry-run-manifest", default=None,
                    help="validate against a vendored HF key/shape manifest "
                         "(wxformer_6h | fuxi_6h) instead of a .pt file")
    _device(sp)
    sp.set_defaults(fn=cmd_convert_checkpoint)

    sp = sub.add_parser("benchmark", help="parallelism micro-benchmark")
    sp.add_argument("config", nargs="?", default=None)
    sp.add_argument("--steps", type=int, default=5)
    sp.add_argument("--combos", default=None,
                    help="comma list of dpxtpxdomain, e.g. 1x1x1,2x1x2")
    sp.add_argument("--halo", action="store_true",
                    help="the explicit halo exchange against the unsharded stencil")
    _device(sp)
    sp.set_defaults(fn=cmd_benchmark)

    sp = sub.add_parser("solar", help="precompute TSI solar-forcing files")
    sp.add_argument("--start", default="2000-01-01")
    sp.add_argument("--end", default="2000-01-02")
    sp.add_argument("--step", default="6h")
    sp.add_argument("--calendar", default="standard")
    sp.add_argument("--nlat", type=int, default=181)
    sp.add_argument("--nlon", type=int, default=360)
    sp.add_argument("--tsi", type=float, default=1361.0)
    sp.add_argument("--var", default="tsi")
    sp.add_argument("--out", default="./solar")
    sp.add_argument("--rank", type=int, default=0)
    sp.add_argument("--world", type=int, default=1)
    sp.set_defaults(fn=cmd_solar)

    sp = sub.add_parser("serve", help="HTTP forecast server")
    sp.add_argument("config")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000)
    _device(sp)
    sp.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

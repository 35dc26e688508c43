#!/usr/bin/env python3
"""Smoke test of the PyTorch port (credit_torch) on one CUDA card.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --ptxas      # also print nvcc's register/smem report
    python3 chip_smoke.py --profile    # also by-kernel profiles of main paths 1-5
                                       # (every row in build/profile_*.txt)
    python3 chip_smoke.py --compare-steps unet|graph ROOT [ROOT ...]
        # only: phase 18(e)'s unsharded U-Net (721x1440) or graph (180x360)
        # f32 training step of each checkout ROOT (a parent commit unpacked
        # beside the tree, say), a process a root, in turns A B B A: ms a
        # step after a warm-up one and the peak

Phases (any failure exits non-zero):
  1. build the kernels from credit_torch/csrc with nvcc (printed seconds);
  2. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes in bf16 and f32 (TF32 off), the FF and its backward
     in both forms (pre-norm: the WXFormer; post-norm: FuXi, and a width the
     bf16 kernel pads; bf16 up to C = 256 on the fused wgmma kernel, the
     hidden layer in registers, bit-identical on a second call at stage 0
     and C = 192, with its TFLOP/s; past C = 256 on the split route, whose
     fc1 and fc2 run on wgmma; the two routes timed in turns at the widths
     both take; every FF beside PyTorch's own composition) and at widths
     the fused kernels do not take (C > 1024, C and hidden not multiples of
     8: the split route in bf16, the forward in passes in f32), window
     attention at the paths' windows, 12x12 and 24x24 windows (T = 144 and
     576: key blocks with an online softmax) and heads of 128, the conv and
     its weight gradient at every shape the paths launch (the conv also at
     ic-opt's input gradient of the stage-0 embed), up to 16x16 taps,
     with channels the wrapper pads and a kernel taller than wide (the
     weight gradient also bit-identical on a second call, as is the FF
     backward in bf16, timed beside PyTorch's autograd of its composition),
     the tools' row-band conv drafts and copy, with the error beside its
     limit and the kernel's, the plain version's and a library call's times;
     the FF's tp entry points (ff_partial, ff_finish, ff_finish_bwd,
     ff_partial_bwd) at a tp rank's shapes, CONF_025's four stages and
     CONF_FUXI's MLP at hidden / 2, bf16 and f32, beside PyTorch's
     composition of the same sliced products, and two ranks' partials
     through ff_finish against fused_ff on the whole weights;
  3. a tiny CrossFormer and a tiny FuXi (two input frames), each with a
     2-step rollout and a training step, on the card against the same model
     on the CPU (plain versions), and each train-mode backward with bf16
     compute on the card against f32 on the CPU; the tiny CrossFormer's
     RolloutEngine with a Normalizer and the four fixers likewise, its
     2-epoch run_training on a seeded 32x64 zarr store (training_log.csv
     cell by cell), as it is and with preblocks in the steps (an IC clamp,
     fill_values, log_transform), run_rollout from that fit's checkpoint
     (two init times of 2 steps, the files compared by diff_rollout), and
     a tiny crossformer-ensemble's members and CRPS train step with the
     same noise on both; and every other model type (the cube embed, the
     sub-pixel decoder, camulator, the downscaling CrossFormer, both
     U-Nets, the debugger, NextGen, wrf, dscale, graph, both diffusion
     backbones), tiny: the f32 forward, bf16 against f32 and a train-mode
     backward on the card against the CPU; and the ensemble slice with the
     same draws on both: the four noise classes, one bred vector, an SDL
     capture replayed, run_rollout with ensemble_size 3 (gaussian and bred)
     from the tiny fit's checkpoint (files by diff_rollout), rollout_metrics'
     and ensemble_eval's rows, 5 ic-opt iterations and ptype's fields; and
     the credit-torch CLI in this process (init, summary, train, rollout,
     metrics, preprocess, submit, solar; train and rollout on the card
     against --device cpu), plot / tune / orbax reading where matplotlib,
     optuna and tensorstore are installed (else a line says so);
  4. main path 1, the forecast: the 0.25-degree WXFormer (CONF_025 below)
     with seeded folded weights in bf16 at batch 1, a warm-up step, then a
     rollout whose kernel launches are counted and checked against the
     config, and three more rollouts timed for the spread;
  5. main path 2, training: CONF_025 with 8 diagnostic outputs, seeded f32
     weights with spectral-norm state, bf16 compute, MSE, AdamW(0.9, 0.95)
     through make_train_step; a warm-up step, then timed steps whose kernel
     launches are counted and checked, with ms/step and peak memory;
  6. main path 3, the FuXi forecast: CONF_FUXI (the reference arXiv FuXi,
     below) as main path 1, with two input frames;
  7. main path 4, FuXi training: CONF_FUXI as main path 2, with two input
     frames;
  8. main path 5, the forecast as users run it: CONF_025_POST (the training
     config's model with its 8 diagnostics named for the conservation
     fixers) through RolloutEngine with a seeded Normalizer and the tracer,
     mass, water and energy fixers; a warm-up step, then timed steps whose
     launches are counted and checked, and each fixer's budget read after
     every step against its limit; each prediction goes to the host
     through the engine's ring of pinned buffers on a side stream, each
     copy's ms printed;
  9. main path 6, the tool benches: credit_torch.tools.bench_conv (cuDNN,
     kernel 2 and the two row-band drafts) and bench_conv_ffk (the 32x32/s2
     conv + 4 FFs in five modes) at full size, launches counted per call;
 10. main path 7, `credit train` at CONF_025: a seeded 721x1440 zarr ERA5
     store (DATA_025's variables, 13 levels, 8 six-hourly times, one zlib
     chunk per (time, level) slab) and its mean/std netCDF files, then
     run_training for 1 epoch of 2 steps and 1 validation batch (EMA,
     best weights, per-variable metrics, prefetch 2), then a resume for one
     more epoch: the log, the checkpoints, the resumed state and the
     launches checked; the step, validation, batch assembly and copy times
     and the peak memory printed; the store read through the native chunk
     pool (every chunk it decodes counted against every chunk read), the
     resumed epoch profiled for the device's idle share;
 11. main path 8, ensemble CRPS training at CONF_025 width: run_training on
     phase 10's store with CONF_025_TRAIN's model as crossformer-ensemble,
     2 members under the almost-fair CRPS, grad_accum_every 2 and
     sn_external, one epoch of 2 micro-steps and 1 validation batch: the
     log, the parameters unchanged after the first micro-step and changed
     after the second, the validation members apart and the launches
     checked; step and validation times and peak memory printed. Phase 3
     also runs a tiny crossformer-ensemble step at 3 members on the card
     against the CPU with the same noise;
 12. main path 9, `credit rollout` at CONF_025 width: run_rollout of phase
     10's config over its store's 8 times from its checkpoint's EMA
     weights, one init time of 4 steps written to netCDF by the
     engine's writer threads: the files' names, every variable's shape, CF
     attributes and finite values, the launches per step, and the first
     file against RolloutEngine.step of the same folded weights; wall
     ms/step with the writes, copy ms, ms and MB per file and peak memory
     printed;
 13. main path 10, `credit train` on computed solar forcing at CONF_025:
     run_training on phase 10's store with tsi taken out of the store's
     dynamic forcing and computed by a `tisr` source on the model grid over
     the store's clock (its mean and std from the computed fields), one
     epoch of 2 steps and 1 validation batch:
     the batch's tsi channel on the card against tisr_accumulated
     recomputed on the host (bitwise), the log finite and the launches
     checked; step, validation, assembly (and the tisr fields' share of
     it) and copy times and the peak memory printed. Then, at full size:
     the regrid preblock (bilinear and nearest 181x360 -> 721x1440,
     conservative 721x1440 -> 181x360, 60 channels) on the card against the
     CPU; divergent_rotational_spectra of phase 12's forecast's U and V (13
     levels, 721x1440) timed as users call it (the SHT's table build on the
     card included) and with the tables prebuilt, host and device memory,
     a round trip of a field band-limited to l < 360 on 721 Gauss
     latitudes, and at 181x360 the tables built on the card bitwise equal
     to the host's and the spectra on the card against the CPU; GOES ABI CONUS, HRRR and MRMS granules at their real
     sizes, two each, one sample read of each on the host;
 14. main path 11, the SKEBS ensemble at CONF_025 width
     (config/examples/ensemble_skebs.yml's pipeline with a learned
     backscatter rate): (a) run_training on phase 10's store of
     CONF_025_ENS, 2 members under the almost-fair CRPS, post_conf's
     tracer fixer on Q and SKEBS at credit_tpu's defaults (lmax 721) with
     the `cnn` net (a 3x3 conv of the 60 inputs onto the 13 levels: kernel
     2 forward, kernel 5 in training), one epoch of 2 steps and 1
     validation batch: the log finite, SKEBS changing U and V only, the
     net's weights moved by the first step and in the EMA and the
     checkpoint under _postblocks.2, the launches; (b) run_rollout from
     that checkpoint's EMA, 1 init time of 4 steps with the pattern carried
     and debug files written, with semi-Lagrangian advection of Q, the
     wind filter and the MSLP diagnostic: the files, the pattern's
     step-to-step correlation, advected Q within its range, the largest
     wind speed not raised, the launches; (c) on that rollout's last
     state, the pole filter (winds and a scalar), the interp postblocks
     and preblock, the geopotential diagnostic and the advection preblock,
     ms a call on the card at full size, its output there finite where the
     block writes and the rest as it came in, and at 181x360 (the state's
     every 4th row and column) ms on the CPU and the card against the CPU;
 15. main path 12, NextGen WXFormer at CONF_025_TRAIN width (CONF_NEXTGEN):
     run_training on phase 10's store, one epoch of 2 steps and 1
     validation batch, its checkpoint read back bitwise, then a 4-step bf16
     rollout; beside it camulator with the sub-pixel decoder at the same
     widths, one training step and a 4-step bf16 rollout; launches per
     step checked and printed;
 16. main path 13, `era5-diffusion` with crossformer-diffusion at
     CONF_025_TRAIN width: one epoch of 2 denoising steps and 1 validation
     batch sampled by DDIM in 20 steps (1000 timesteps, sigmoid schedule,
     v-prediction) on phase 10's store: the log, the checkpoint, the
     launches; ms a step, a validation batch and a DDIM step, peak memory;
 17. main path 14, ensemble forecasts and their verification at CONF_025
     width from phase 10's store and checkpoint: (a) run_rollout with
     ensemble_size 4 (gaussian) then 3 (bred, 3 cycles), one init time of 2
     steps: the <init>_eNN directories and files, the members apart from
     the control, the bred pair mirrored at the IC with its amplitude, the
     launches; ms/step with the writes by member, set-up and its draws,
     peak; (b)
     run_rollout_metrics with 4 members, gaussian and bred (credit_tpu's
     bred harness raises at 3), 2 steps: rows finite, spread > 0, launches;
     (c) run_ensemble_eval over (a)'s gaussian tree, one lead: rows finite,
     spread > 0, the SHT built once for the 13 spectra calls, the seconds
     and the build's share; (d) ic-opt on the folded weights in bf16, 2
     steps and 3 iterations on targets from the store: the loss falls, x0
     moves, kernels 1-4 launched and 5 not; ms an iteration, peak; then
     the gradient at x0 through the kernels against the plain convs'; (e) ptype
     on (a)'s control prediction at 721x1440, seeded weights, card against
     CPU, probabilities summing to 1, one-hot winners; (f) the SDL wrapper
     on CONF_025_ENS: capture replayed bitwise, every factor 0 making two
     draws equal, interpolation at t = 0 equal to the first capture;
 18. main path 15, parallelism on the one card: (a) run_training at
     CONF_025_TRAIN through maybe_initialize (the CREDIT_* variables, a
     file:// rendezvous) over NCCL at world size 1 with data: none, one
     step and one validation batch on phase 10's store: the gradient and
     loss all-reduced over NCCL, the log, the launches; (b) two processes
     of this script (--parallel-rank) sharing the card over gloo, domain 2
     with the explicit halo: one CONF_025_TRAIN step of seeded weights on
     a seeded batch against the unsharded step (loss, gradient), each
     rank's launches equal to the unsharded step's, kernel 2 on slabs
     (its largest input 215 rows against 415) and kernel 1 on half the
     rows; the same for its crossformer-ensemble and for CONF_FUXI
     (`fuxi_domain2`: the cube embed, the DownBlock's 3x3/s2 conv and the
     residual convs on 100-row slabs, the 16 SwinV2 blocks on window
     slabs of 56 and 49 rows); (c) the same two ranks at data 2 under
     ZeRO-3 (`dp2`, CONF_025_TRAIN; `fuxi_dp2`, CONF_FUXI) against the
     unsharded step on the batch of 2, each rank's parameter and gradient
     bytes between the steps its chunks plus the whole small tensors,
     ring-CRPS at 2 members against the dense CRPS, and benchmark_halo at
     800x1440x128 bf16; (d) the same two ranks at tensor 2 (`tp2`,
     CONF_025_TRAIN; `fuxi_tp2`, CONF_FUXI) against the unsharded step:
     every FF on kernels 1 and 4's tp entries at half the hidden width,
     each rank's launches and widths, the tp all-reduces and their bytes,
     the peaks; (e) the same two ranks at domain 2 for the models
     lat-sharded last: NextGen at CONF_NEXTGEN's widths on 640x1280
     (`ng_domain2`: kernels 1-5 on slabs, the bottleneck's pooled nodes
     summed over the ranks), the U-Net at 721x1440 in f32
     (`unet_domain2`: its deepest level gathered) and the graph at 180x360
     (`graph_domain2`), each step against the unsharded one, with each
     rank's launches, kernel 2's largest input rows, the gather paths, the
     bottleneck's all-reduces and each rank's peak against the unsharded
     step's, the U-Net's and the graph's unsharded step ms and peak, and
     the graph's steps run twice for the same bits; no time of two ranks
     on one card is a throughput figure.
     Phase 2 checks kernels 2 and 5 at NextGen's and the U-Net's slab
     shapes. Removes phase 10's store.
 19. main path 16, the applications and interfaces: (a) `python -m
     credit_torch convert-checkpoint --dry-run-manifest` for the published
     wxformer_6h and fuxi_6h layouts (two processes at once, each strict
     into the port's model on the card at full width), while a seeded
     640x1280 zarr store of their 74 inputs and three GFS-like 0.25-degree
     cubes (721x1440, 13 pressure levels) are written; (b) `credit-torch
     realtime` (in this process) of the converted wxformer_6h in bf16, 4
     steps to netCDF, then GEFS with 3 members for 2 steps: the IC on the
     card against nwp.build_gfs_init on the CPU at every 16th row, each
     file against RolloutEngine.step of the folded weights, the GEFS
     control against the single run, the launches a step; (c)
     `credit-torch serve`'s server on 127.0.0.1: /health, three POST
     /forecast of 4 steps against an engine run in this process, /field
     against the file, the launches; (d) bf16 steps of the converted
     fuxi_6h (its input on the card): ms, peak, launches, one step
     profiled by kernel, the prediction against the same step on the
     plain versions of kernels 1 and 2, both from an f32 forward on the
     plain versions. Phase 2 checks the five convs and the FF shape of
     this path that main path 1 does not launch. Removes its directory.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the flagship 0.25-degree WXFormer (the JAX bench's CONF_025):
# 721x1440 grid, 60 input channels, earth padding 39/40 in latitude
CONF_025 = {
    "type": "crossformer", "frames": 1, "image_height": 721,
    "image_width": 1440, "levels": 13, "channels": 4, "surface_channels": 4,
    "input_only_channels": 4, "output_only_channels": 0,
    "dim": [128, 256, 512, 1024], "depth": [2, 2, 8, 2], "dim_head": 32,
    "global_window_size": [10, 5, 2, 1], "local_window_size": 10,
    "cross_embed_kernel_sizes": [[4, 8, 16, 32], [2, 4], [2, 4], [2, 4]],
    "cross_embed_strides": [2, 2, 2, 2], "interp": True,
    "use_spectral_norm": True, "compute_dtype": "bfloat16",
    "padding_conf": {"activate": True, "mode": "earth",
                     "pad_lat": [39, 40], "pad_lon": [0, 0]},
}
# its data section: 4 3-D vars x 13 levels + 4 surface = 56 prognostic,
# 2 static, 2 dynamic forcing = 60 inputs
DATA_025 = {"source": {"ERA5": {
    "levels": list(range(13)),
    "variables": {
        "prognostic": {"vars_3D": ["U", "V", "T", "Q"],
                       "vars_2D": ["SP", "VAR_2T", "VAR_10U", "VAR_10V"]},
        "dynamic_forcing": {"vars_2D": ["tsi", "ci_mask"]},
        "static": {"vars_2D": ["z_norm", "lsm"]},
        "diagnostic": {"vars_2D": [f"d{i}" for i in range(8)]},
    }}}}

TINY = {
    "type": "crossformer", "frames": 1, "image_height": 32, "image_width": 64,
    "levels": 2, "channels": 2, "surface_channels": 2, "input_only_channels": 1,
    "output_only_channels": 0, "dim": [32, 64, 128, 256], "depth": [1, 1, 1, 1],
    "dim_head": 16, "global_window_size": [2, 2, 1, 1], "local_window_size": 2,
    "cross_embed_kernel_sizes": [[4, 8, 16, 32], [2, 4], [2, 4], [2, 4]],
    "cross_embed_strides": [2, 2, 2, 2], "interp": True, "use_spectral_norm": True,
    "padding_conf": {"activate": True, "mode": "earth", "pad_lat": [16, 16], "pad_lon": [0, 0]},
}
TINY_DATA = {"source": {"ERA5": {
    "levels": [0.0, 1.0],
    "variables": {"prognostic": {"vars_3D": ["U", "T"], "vars_2D": ["SP", "T2M"]},
                  "dynamic_forcing": {"vars_2D": ["TISR"]}}}}}

# the reference arXiv FuXi (the JAX bench's CONF_FUXI): 640x1280, two input
# frames, 2x4x4 cube patches, dim 1024, 16 SwinV2 blocks in windows of 7,
# earth padding 80/80 in latitude; ~260.7 M parameters
CONF_FUXI = {
    "type": "fuxi", "frames": 2, "frame_patch_size": 2,
    "image_height": 640, "image_width": 1280,
    "patch_height": 4, "patch_width": 4,
    "levels": 16, "channels": 4, "surface_channels": 7,
    "input_only_channels": 3, "output_only_channels": 0,
    "dim": 1024, "num_groups": 32, "num_heads": 8, "window_size": 7,
    "depth": 16, "use_spectral_norm": True, "interp": True, "compute_dtype": "bfloat16",
    "padding_conf": {"activate": True, "mode": "earth",
                     "pad_lat": [80, 80], "pad_lon": [0, 0]},
}
# its data section: 4 3-D vars x 16 levels + 7 surface = 71 prognostic
# (all the outputs), 2 static and tsi = 74 inputs
DATA_FUXI = {"source": {"ERA5": {
    "levels": list(range(16)),
    "variables": {
        "prognostic": {"vars_3D": ["U", "V", "T", "Q"],
                       "vars_2D": ["SP", "VAR_2T", "VAR_10U", "VAR_10V", "V500", "U500",
                                   "T500"]},
        "dynamic_forcing": {"vars_2D": ["tsi"]},
        "static": {"vars_2D": ["z_norm", "lsm"]},
        "diagnostic": {"vars_2D": []},
    }}}}
# credit_tpu's tiny FuXi test config (its stage zero-pads 5x9 to 8x12)
TINY_FUXI = {
    "type": "fuxi", "image_height": 32, "image_width": 64, "patch_height": 4,
    "patch_width": 4, "levels": 2, "frames": 2, "frame_patch_size": 2, "dim": 32,
    "num_groups": 8, "channels": 2, "surface_channels": 2, "input_only_channels": 1,
    "output_only_channels": 1, "num_heads": 4, "depth": 2, "window_size": 4,
    "use_spectral_norm": True, "interp": True,
    "padding_conf": {"activate": True, "mode": "earth", "pad_lat": [4, 4], "pad_lon": [4, 4]},
}
TINY_FUXI_DATA = {"source": {"ERA5": {
    "levels": [0.0, 1.0],
    "variables": {"prognostic": {"vars_3D": ["U", "T"], "vars_2D": ["SP", "T2M"]},
                  "dynamic_forcing": {"vars_2D": ["TISR"]},
                  "diagnostic": {"vars_2D": ["PRECIP"]}}}}}

# published dense peaks of one H100 SXM at 700 W; "3xtf32": f32 products
# as three products at TF32's 495 TFLOP/s (kernels 2 and 5 in f32)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12

# bf16 train-mode loss, gradients by norm and worst parameter of the tiny
# models against f32, relative: a few times above the readings (bf16
# rounding, not summation order) -- the CrossFormer's on the card (1.63e-4,
# 1.35e-2, 6.5e-2), FuXi's with the plain versions in bf16 on a CPU
# (6.4e-4, 2.7e-2, 2.1e-2)
BF16_TRAIN_LIMITS = {"crossformer": (1e-3, 5e-2, 0.25), "fuxi": (3e-3, 0.1, 0.25)}

# main path 7, credit train: CONF_025_TRAIN on a store of DATA_025's
# variables at 13 pressure levels and FIT_TIMES six-hourly times; 3 training
# init times (00-24 h) and 1 validation init time (30-42 h), batch 1
FIT_LEVELS = [50.0, 100.0, 150.0, 200.0, 250.0, 300.0, 400.0, 500.0, 600.0, 700.0, 850.0,
              925.0, 1000.0]
FIT_TIMES = 8
# (2 batches an epoch: cut from 3 for the script's time)
FIT_TRAINER = {"train_batch_size": 1, "num_epoch": 2, "batches_per_epoch": 2,
               "valid_batches_per_epoch": 1, "use_ema": True, "save_best_weights": True,
               "log_variable_metrics": True, "prefetch": 2, "learning_rate": 1e-4}
# phase 10's first run_training: 1 epoch before the resumed one (cut from
# FIT_TRAINER's 2 for phase 18(e)'s time)
FIT_EPOCHS = 1
# the tiny fit of phase 3 on the card against the CPU, f32: every log cell
# but its seconds, relative; its rollouts' files by diff_rollout (each
# variable against its maximum)
TINY_FIT_TOL = 1e-4
# phase 3's second tiny fit: an IC clamp, then every step NaN/inf filled and
# log1p of surface pressure (in normalized units)
TINY_PREBLOCKS = [{"type": "clamp", "phase": "ic_only", "min": -3.0, "max": 3.0},
                  {"type": "fill_values"}, {"type": "log_transform", "variables": ["SP"]}]
# phase 10 before the native chunk pool (one thread inflating every chunk)
# on one NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md), printed beside its own
# figures: batch assembly, train step, the profiled resumed epoch's idle share
ONE_THREAD_FIT = "assembly 7.4-9.7 s a batch, train step ~390-420 ms, idle 0.978"
# main path 8, ensemble CRPS training: CONF_025_TRAIN's model as credit_tpu's
# noise-injection CrossFormer (crossformer-ensemble), 2 members, the
# almost-fair CRPS with latitude weights for training and validation,
# gradients accumulated over 2 micro-steps, spectral norm iterated outside
# the step; one epoch of 2 micro-steps (1 update; cut from 4 for phase 14's
# time) and 1 validation batch on phase 10's store, batch 1
ENS_TRAINER = {"train_batch_size": 1, "num_epoch": 1, "batches_per_epoch": 2,
               "valid_batches_per_epoch": 1, "use_ema": True, "log_variable_metrics": True,
               "prefetch": 2, "learning_rate": 1e-4, "ensemble_size": 2,
               "grad_accum_every": 2, "sn_external": True}
ENS_LOSS = {"training_loss": "almost-fair-crps", "validation_loss": "almost-fair-crps",
            "use_latitude_weights": True}
# phase 10's clock windows: 3 training init times (00-12 h) and 1 validation
# init time (30 h); phase 11's training window runs 6 hours longer, 4 init
# times (00-18 h) for its sampler to draw its micro-steps from
FIT_WINDOWS = (("1979-01-01T00", "1979-01-02T00"), ("1979-01-02T06", "1979-01-02T18"))
ENS_WINDOWS = (("1979-01-01T00", "1979-01-02T06"), FIT_WINDOWS[1])
# phase 3's tiny ensemble step: its members
TINY_MEMBERS = 3
# main path 14, ensemble forecasts at CONF_025 width from phase 10's
# checkpoint: one init time of ENS_STEPS; gaussian members perturbed by
# credit_tpu's default perturbation_std (physical units), bred members of
# amplitude 0.05 (normalized units) over 3 cycles; rollout_metrics at
# ENS_MEMBERS members (bred at 4 is what credit_tpu cannot run); ic-opt of
# ICOPT_ITERS iterations over ICOPT_STEPS steps; ptype's fields card against
# CPU within PTYPE_TOL of each field's largest value
ENS_STEPS = 2
ENS_GAUSSIAN = {"ensemble_size": 4, "perturbation": "gaussian", "perturbation_std": 1e-3,
                "seed": 0}
ENS_BRED = {"ensemble_size": 3, "perturbation": "bred", "perturbation_std": 0.05,
            "bred_cycles": 3, "seed": 0}
ENS_MEMBERS = 4
ICOPT_STEPS = 2
ICOPT_ITERS = 3
PTYPE_TOL = 1e-5
# ic-opt's gradient at x0 through the kernels against the same gradient
# with every conv on its plain version (bf16 compute both): their relative
# L2 distance within ICOPT_GRAD_FACTOR times the distance that the plain
# version summing its taps in the reverse order gives. The convs sum in f32
# in other orders, so a bf16 output rounds the other way here and there,
# and that spreads through the backward (on one H100, with phase 10's
# weights, the kernels read 7.32e-3, the reversed sums 7.26e-3); a wrong
# input gradient (kernel
# unflipped, channels swapped) reads about 1
ICOPT_GRAD_FACTOR = 3.0

ROLLOUT_STEPS = 3
# rollouts timed again after the counted one, for the spread: the host sets
# the WXFormer's step time, and one timed rollout read from 42.7 to 92.0
# ms/step on one H100 80GB HBM3 at 700 W from call to call (PERF.md)
ROLLOUT_REPEATS = 3
TRAIN_STEPS = 3
POST_STEPS = 3
# phase 8 before the pinned copy ring (RolloutEngine.run copying each
# prediction to pageable memory in stream order) on one NVIDIA H100 80GB
# HBM3 at 700.00 W (PERF.md), printed beside its own
POST_PAGEABLE = "149.0-175.8 ms/step"
# main path 9, credit rollout at CONF_025 width: phase 10's run (config,
# checkpoint, EMA) and store, its whole clock (8 six-hourly times), one init
# time (00 h) of 4 steps (cut from two init times of 6 steps for phase
# 14's time); each file
# against RolloutEngine.step straight from the folded model, relative to the
# variable's maximum (bf16 compute on both sides)
NC_WINDOW = ("1979-01-01T00", "1979-01-02T18")
NC_INIT_HOURS = (0,)
NC_STEPS = 4
NC_TOL = 1e-2
# main path 10, credit train on computed solar forcing: CONF_025_TRAIN on
# phase 10's store with tsi taken out of the store's dynamic forcing and
# computed by a `tisr` source (SUN: 6-hour accumulations, J/m^2) on the
# model grid over the store's clock; one epoch of 2 steps and 1 validation
# batch in phase 10's windows
TISR_TRAINER = {**FIT_TRAINER, "num_epoch": 1, "batches_per_epoch": 2}
SUN_SOURCE = {"dataset_type": "tisr", "variables": {"dynamic_forcing": {"vars_2D": ["tsi"]}}}
# phase 13's regrid preblock at full size on a (1, 1, H, W, 60) f32 batch,
# (method, source grid, destination grid), the card against the CPU
# relative to max |x|
REGRID_CASES = (("bilinear", (181, 360), (721, 1440)), ("nearest", (181, 360), (721, 1440)),
                ("conservative", (721, 1440), (181, 360)))
REGRID_TOL = 1e-5
# phase 13's SHT: a field band-limited to l < SHT_BAND through grid2spec and
# spec2grid on 721 Gauss-Legendre latitudes, relative to max |f| (on the
# equiangular grid the quadrature is approximate: credit_tpu's own round-trip
# test allows 2e-2 there, so that reading is printed, not held); the spectra
# at 181x360 on the card against the CPU, relative to each one's largest
SHT_BAND = 360
SHT_ROUNDTRIP_TOL = 1e-4
SHT_SPECTRA_TOL = 1e-5
# phase 13's granules at real sizes (y, x): GOES-16 ABI CONUS (the MCMIPC
# sector, 56-microradian pixels from these scan angles; three bands), HRRR
# on its Lambert grid (T and U at five pressure levels), the MRMS CONUS
# mosaic (0.01 degrees)
GOES_SHAPE, GOES_X0, GOES_Y0, GOES_STEP = (1500, 2500), -0.101332, 0.128212, 56e-6
HRRR_SHAPE, HRRR_LEVELS = (1059, 1799), [250.0, 500.0, 700.0, 850.0, 925.0]
MRMS_SHAPE = (3500, 7000)
# main path 11, the SKEBS ensemble (config/examples/ensemble_skebs.yml at
# CONF_025 width): CONF_025_ENS under the almost-fair CRPS with the tracer
# fixer on Q and SKEBS at credit_tpu's defaults (lmax 721, pattern filter
# to degree 60) with a learned backscatter rate (the cnn net: a 3x3 conv
# of the 60 inputs onto the 13 levels); 2 members, one epoch of 2 steps
# and 1 validation batch in phase 10's windows, batch 1, no gradient
# accumulation (the net's weights move at the first step)
SKEBS_TRAINER = {"train_batch_size": 1, "num_epoch": 1, "batches_per_epoch": 2,
                 "valid_batches_per_epoch": 1, "use_ema": True, "log_variable_metrics": True,
                 "prefetch": 2, "learning_rate": 1e-4, "ensemble_size": 2, "grad_max_norm": 1.0}
SKEBS_POST = {"activate": True,
              "tracer_fixer": {"activate": True, "tracer_vars": ["Q"], "tracer_thres": 0.0},
              "skebs": {"activate": True, "backscatter_net": {"type": "cnn"}}}
# then run_rollout from that checkpoint's EMA: 1 init time (00 h) of
# SKEBS_STEPS steps, the pattern carried, with semi-Lagrangian advection of
# Q, the wind filter and the MSLP diagnostic (into d0) after SKEBS; the
# stream-function patterns of consecutive steps correlated at least
# SKEBS_CORR (an AR(1) with alpha 0.05 after 5 spin-up cycles: ~0.89 at the
# first pair, rising; a pattern drawn afresh each step reads ~0)
SKEBS_STEPS = 4
SKEBS_CORR = 0.8
# the wind filter's speed threshold (m/s; credit_tpu's default 40): the
# seeded model's winds at the mask level (the lowest) stay well below 40, so
# it is lowered for the filter to blend a share of the grid on every step;
# the rollout gates that share at WIND_SHARE or more on each step (it
# prints the mask level's peak speed and the share beside it)
WIND_THRESHOLD = 10.0
WIND_SHARE = 0.01
# beside it on that rollout's last state, timed on the card at full size,
# and on that state subsampled to PHYS_CHECK_GRID (every 4th row and
# column: the CPU legs at full size took ~95 s) the card against the port
# on the CPU, for each variable a block writes and each of its levels,
# relative to that level's largest |CPU value|: the geopotential
# diagnostic (one f32 column each, the same operations) and the wind filter
# within PHYS_TOL; the pole filter (~50 chained transforms, each a sum over
# the latitudes in another order on each side) within POLE_TOL; the
# interpolations in log pressure within the bound LOGP_ROUND gives (each
# output is y0 + w (y1 - y0), w a difference of logs over a layer's log
# thickness; the two sides' logs of the same f32 pressures differ by an ulp
# or two each, at most 2^-20 for logs below 16: so an output moves by at
# most its column's steepest jump per unit of log p times 8 such ulps),
# plus PHYS_TOL; advection's departure points as far from the CPU's in f64
# as the CPU's own in f32, within DEP_FACTOR and DEP_TOL cells (by the
# poles they are ill-conditioned), and the advected Q within the bound the
# card's and the CPU's points' distance gives
PHYS_CHECK_GRID = (181, 360)
PHYS_TOL = 1e-5
POLE_TOL = 1e-4
LOGP_ROUND = 8 * 2.0**-20
DEP_FACTOR, DEP_TOL = 4.0, 1e-3
# bench_conv_ffk's modes in phase 9: the plain FFs, the kernel's, and the
# three identity copies
FFK_MODES = ("xla", "pallas", "identity", "identity-input", "identity-end")
# the JAX training bench's configuration (bench.py:557-630): CONF_025 with
# output_only_channels raised so that the outputs cover the 8 diagnostic
# targets (64 outputs, a 256 -> 256 head phase conv), forecast_len 1, batch 1
CONF_025_TRAIN = {**CONF_025, "output_only_channels": 8}
CONF_025_ENS = {**CONF_025_TRAIN, "type": "crossformer-ensemble"}
TRAINER = {"learning_rate": 1e-4}

# main path 12: NextGen WXFormer at CONF_025_TRAIN's widths, depths,
# windows, channels and bf16 compute on the 721x1440 grid, which it does
# not pad: its stage 3 is 45x90, so its local window there is 5 (10 does
# not divide 45); 64 virtual nodes over the 4,050 stage-3 nodes
CONF_NEXTGEN = {**{k: v for k, v in CONF_025_TRAIN.items() if k not in ("padding_conf", "interp")},
                "type": "nextgen_wxformer", "local_window_size": [10, 10, 10, 5]}
# beside it, camulator with the sub-pixel decoder at CONF_025_TRAIN
CONF_CAMULATOR_PS = {**CONF_025_TRAIN, "type": "camulator", "upsample_with_ps": True}
# main path 13: the diffusion CrossFormer at CONF_025_TRAIN: the condition
# (60 channels) and the noisy target (64) enter cel0 together, 124 channels
CONF_DIFFUSION = {**CONF_025_TRAIN, "type": "crossformer-diffusion"}
# main paths 12 and 13: one epoch of 2 steps and 1 validation batch on
# phase 10's store, batch 1
ZOO_TRAINER = {"train_batch_size": 1, "num_epoch": 1, "batches_per_epoch": 2,
               "valid_batches_per_epoch": 1, "learning_rate": 1e-4, "use_ema": True,
               "ema_decay": 0.999, "prefetch": 2}
# the diffusion trainer's defaults: 1000 timesteps, DDIM in 20 steps,
# sigmoid schedule, v-prediction
DIFFUSION = {"timesteps": 1000, "sampling_timesteps": 20, "beta_schedule": "sigmoid",
             "objective": "pred_v"}
ZOO_ROLLOUT_STEPS = 4
# phase 3's tiny model zoo: (model section, input (B, T, H, W, C), the
# extra inputs' shapes), as tests/test_torch_port_models.py builds them
_CF = dict(frames=1, output_frames=1, image_height=32, image_width=64, levels=2, channels=2,
           surface_channels=1, input_only_channels=1, output_only_channels=1,
           dim=[16, 32, 64, 128], depth=[1, 1, 1, 1], global_window_size=[2, 2, 2, 1],
           local_window_size=2, cross_embed_kernel_sizes=[[2, 4], [2, 4], [2, 4], [2, 4]],
           cross_embed_strides=[2, 2, 2, 2], use_spectral_norm=True, dim_head=8, interp=True)
_PI = dict(image_height=32, image_width=32, patch_height=2, patch_width=2, levels=2, frames=1,
           frame_patch_size=1, channels=2, surface_channels=1, input_only_channels=1,
           output_only_channels=0, dim=32)
_UN = dict(frames=1, image_height=30, image_width=60, levels=2, channels=2, surface_channels=1,
           input_only_channels=1, output_only_channels=1, encoder_dims=[8, 16, 32])
TINY_ZOO = {
    "crossformer cube embed": ({"type": "crossformer", **_CF, "frames": 2, "patch_height": 2,
                                "patch_width": 2, "local_window_size": [2, 2, 2, 1],
                                "global_window_size": [2, 2, 1, 1]}, (1, 2, 32, 64, 6), ()),
    "crossformer upsample_with_ps": ({"type": "crossformer", **_CF, "upsample_with_ps": True},
                                     (1, 1, 32, 64, 6), ()),
    "camulator": ({"type": "camulator", **_CF}, (1, 1, 32, 64, 6), ()),
    "crossformer_downscaling": ({"type": "crossformer_downscaling", **_CF,
                                 "out_image_height": 48, "out_image_width": 80},
                                (1, 1, 32, 64, 6), ()),
    "unet": ({"type": "unet", **_UN, "use_spectral_norm": True}, (1, 1, 30, 60, 6), ()),
    "unet_downscaling": ({"type": "unet_downscaling", **_UN, "frames": 2},
                         (1, 2, 15, 30, 6), ()),
    "debugger": ({"type": "debugger", "frames": 2, "image_height": 8, "image_width": 16,
                  "levels": 2, "channels": 2, "surface_channels": 1, "input_only_channels": 1},
                 (2, 2, 8, 16, 6), ()),
    "nextgen_wxformer": ({"type": "nextgen_wxformer",
                          **{k: v for k, v in _CF.items() if k != "interp"}, "frames": 2,
                          "channels": 4, "levels": 3, "col_attn_heads": 2,
                          "num_spectral_nodes": 4}, (1, 2, 32, 64, 14), ()),
    "wrf": ({"type": "wrf", "param_interior": _PI,
             "param_outside": dict(_PI, channels=1, input_only_channels=0), "time_encode_dim": 4,
             "depth": 2, "num_heads": 4, "window_size": 4, "num_groups": 8},
            (2, 1, 32, 32, 6), ((2, 1, 32, 32, 3), (2, 4))),
    "dscale": ({"type": "dscale", "image_height": 32, "image_width": 32, "out_image_height": 48,
                "out_image_width": 64, "patch_height": 2, "patch_width": 2,
                "total_input_channels": 7, "total_target_channels": 11, "time_encode_dim": 4,
                "frames": 1, "frame_patch_size": 1, "dim": 32, "depth": 2, "num_heads": 4,
                "window_size": 4, "num_groups": 8}, (1, 1, 32, 32, 7), ((1, 4),)),
    "graph": ({"type": "graph", "image_height": 8, "image_width": 16, "levels": 2,
               "channels": 2, "surface_channels": 1, "hidden_size": 16, "n_blocks": 3,
               "heads": 2, "knn": 4, "output_frames": 2}, (2, 1, 8, 16, 5), ()),
    "crossformer-diffusion": ({"type": "crossformer-diffusion", **_CF}, (2, 1, 32, 64, 6),
                              ((2, 1, 32, 64, 6), (2,))),
    "unet-diffusion": ({"type": "unet-diffusion", **_UN}, (2, 1, 30, 60, 6),
                       ((2, 1, 30, 60, 6), (2,))),
}

# the forecast as users run it (CONF_025_POST): CONF_025_TRAIN's model, its 8
# diagnostics named for the conservation fixers (the reference's ERA5
# configs), a seeded Normalizer, the tracer (Q >= 0), mass, water and energy
# (net-flux form, tsi as the TOA input) fixers on 14 seeded monotone hybrid
# coefficients and a seeded surface geopotential
FIXER_DIAGNOSTICS = [
    "total_precipitation", "evaporation", "top_net_solar_radiation",
    "top_net_thermal_radiation", "surface_net_solar_radiation",
    "surface_net_thermal_radiation", "surface_sensible_heat_flux", "surface_latent_heat_flux"]
DATA_025_POST = {"source": {"ERA5": {
    **DATA_025["source"]["ERA5"],
    "variables": {**DATA_025["source"]["ERA5"]["variables"],
                  "diagnostic": {"vars_2D": FIXER_DIAGNOSTICS}}}}}
# physical mean and spread of each variable the seeded Normalizer sees
STATS = {"U": (0.0, 10.0), "V": (0.0, 8.0), "T": (250.0, 20.0), "Q": (0.004, 0.004),
         "SP": (1e5, 1000.0), "VAR_2T": (280.0, 15.0), "VAR_10U": (0.0, 5.0),
         "VAR_10V": (0.0, 5.0), "tsi": (300.0, 150.0), "ci_mask": (0.1, 0.3),
         "total_precipitation": (1e-4, 5e-4), "evaporation": (-5e-5, 1e-4),
         "top_net_solar_radiation": (240.0, 100.0), "top_net_thermal_radiation": (-240.0, 40.0),
         "surface_net_solar_radiation": (160.0, 80.0),
         "surface_net_thermal_radiation": (-60.0, 30.0),
         "surface_sensible_heat_flux": (-20.0, 30.0), "surface_latent_heat_flux": (-80.0, 50.0)}
LEAD_SECONDS = 6 * 3600  # the fixers' default lead_time_periods, 6 hours
# each fixer's budget after every step, relative (as tests/test_conservation.py
# reads them, in f64 on the card): dry-air mass against the input state's;
# the water budget's residual against sum |precipitation flux|; the energy
# budget's against the net flux term
POST_LIMITS = {"mass": 1e-4, "water": 1e-3, "energy": 5e-3}
TINY_POST = {**TINY, "channels": 4, "surface_channels": 1, "output_only_channels": 8}
TINY_POST_DATA = {"source": {"ERA5": {
    "levels": [0.0, 1.0],
    "variables": {"prognostic": {"vars_3D": ["U", "V", "T", "Q"], "vars_2D": ["SP"]},
                  "dynamic_forcing": {"vars_2D": ["tsi"]},
                  "diagnostic": {"vars_2D": FIXER_DIAGNOSTICS}}}}}


T_START = time.time()


def log(msg: str) -> None:
    if msg.startswith("phase "):
        msg += f" [{time.time() - T_START:.1f} s]"
    print(msg, flush=True)


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_case(name, dtype, kernel_fn, plain_fn, library_fn, nbytes, flops, tol, iters,
               peak: str | None = None):
    """Compare a kernel with its plain version on the same inputs; time all
    three. tol is relative to max |plain|, for each output of a kernel that
    returns several (the printed error and limit are the worst output's).
    `bound_ms` is at the peak of the units the kernel runs on, `peak` (a
    key of PEAK_FLOPS, the dtype's by default); where that is not the
    dtype's, `fma_bound_ms` is the bound at the dtype's FMA peak too."""
    import torch

    from credit_torch.tools import cuda_ms

    outs, refs = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if isinstance(outs, torch.Tensor):
        outs, refs = (outs,), (refs,)
    err = limit = scale = 0.0
    ok = True
    for out, ref in zip(outs, refs):
        if out.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
        e = (out.float() - ref.float()).abs().max().item()
        sc = ref.float().abs().max().item()
        ok = ok and math.isfinite(e) and e <= tol * sc
        if not math.isfinite(e) or e / max(tol * sc, 1e-30) >= err / max(limit, 1e-30):
            err, limit, scale = e, tol * sc, sc
    ms = cuda_ms(kernel_fn, iters)
    plain_ms = cuda_ms(plain_fn, max(1, iters // 4))
    lib_ms = cuda_ms(library_fn, iters) if library_fn is not None else None
    peak = peak or dtype
    b_ms, b_by = bound(nbytes, flops, peak)
    fma = bound(nbytes, flops, dtype) if peak != dtype else None
    log(f"  {name} [{dtype}] max_abs_err {err:.3e} limit {limit:.3e} (={tol:g} x max|ref| "
        f"{scale:.3e}) ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms {b_ms:.4f} ({b_by}, {peak})"
        + (f" fma_bound_ms {fma[0]:.4f} ({fma[1]})" if fma else "")
        + f"{'' if ok else '  FAIL'}")
    if not ok:
        raise AssertionError(f"{name} [{dtype}]: kernel disagrees with its plain version")
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms}
    if fma:
        out["fma_bound_ms"] = fma[0]
    return out


def f32_limit(products: int) -> float:
    """Phase 2's f32 limit, of max |ref|, for outputs that each sum
    `products` products in f32. The sum's rounding grows as the count's
    square root (a random walk): kernel 2's FMA form read 5.2e-6 of max
    |plain| at the 8x8 (15,360 products) and 1.03e-5 at the 16x16 (61,440),
    twice as much, and the same against f64 sums, where the plain
    version's GEMMs read <= 1.7e-6. So 1e-5 up to 15,360 products, growing
    with that root beyond, keeps the 8x8's margin of about 2."""
    return 1e-5 * math.sqrt(max(1.0, products / 15360))


def check_f64(name: str, exact, forms: dict, limit: float) -> None:
    """Each form's error against f64 sums `exact`, of max |exact|, printed;
    the kernel's (forms["kernel"]) must be within `limit`. TF32 keeps 10
    mantissa bits, so a product that lost its lo parts reads ~1e-4 here."""
    sc = exact.abs().max().item()
    errs = {k: (f().double() - exact).abs().max().item() / sc for k, f in forms.items()}
    ok = errs["kernel"] <= limit
    log(f"    against f64 sums, of max |ref|: "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f"; limit {limit:.3e}{'' if ok else '  FAIL'}")
    if not ok:
        raise AssertionError(f"{name} [float32]: {errs['kernel']:.3e} from f64 sums, "
                             f"limit {limit:.3e}")


# kernel 2's shapes (n, hp, wp, cin, kh, kw, cout) with the dtypes checked.
# WXFormer: the stage-0 quadrant embed after space-to-depth; the final 3x3
# phase conv of the ConvTranspose head (ragged: 402x722 input, 224
# outputs); the stage 1-3 embeds (2x2 after space-to-depth) and the
# UpBlocks' 3x3 residual convs. FuXi: the DownBlock's 3x3/s2 conv after its
# zero-extension to 4x4 and space-to-depth (2x2 over 4096 channels, 7 of 16
# taps zero), its 3x3 residual convs at 100x160 and the UpBlock's at
# 200x320. The conv bench's 32x32/s2 embed is a 16x16 conv. SKEBS's learned
# backscatter net (cnn, main path 11): one f32 3x3 conv of the 60 input
# channels to the 13 levels' rates (odd: the wrapper pads it) on the
# earth-padded 723x1442 grid, both members at once. Beyond the paths:
# channels that are not multiples of 8 (the wrapper pads them) and a kernel
# taller than wide
BF16, F32, BOTH = ("bfloat16",), ("float32",), ("bfloat16", "float32")
# main paths 12 and 13's conv shapes that the earlier paths do not launch
# (bf16, forward and weight gradient). NextGen on the unpadded 721x1440
# grid: its embeds, each UpBlockPS's sub-pixel conv (Cout 4x its output)
# and its 3x3 sharp / residual convs, the head's sub-pixel conv; camulator
# with the sub-pixel decoder on the padded grid: the sub-pixel convs and
# the 3x3 refine and sharp convs at 802x1442; the diffusion CrossFormer's
# stage-0 embed over 124 channels (496 after space-to-depth)
NEW_CONV_SHAPES = [
    ("nextgen_stage0_embed_8x8", (1, 376, 735, 240, 8, 8, 176)),
    ("nextgen_stage1_embed_2x2", (1, 181, 361, 512, 2, 2, 256)),
    ("nextgen_stage2_embed_2x2", (1, 91, 181, 1024, 2, 2, 512)),
    ("nextgen_stage3_embed_2x2", (1, 46, 91, 2048, 2, 2, 1024)),
    ("nextgen_ps1_3x3", (1, 47, 92, 1024, 3, 3, 2048)),
    ("nextgen_ps1_res_3x3", (1, 92, 182, 512, 3, 3, 512)),
    ("nextgen_ps2_3x3", (1, 92, 182, 1024, 3, 3, 1024)),
    ("nextgen_ps2_res_3x3", (1, 182, 362, 256, 3, 3, 256)),
    ("nextgen_ps3_3x3", (1, 182, 362, 512, 3, 3, 512)),
    ("nextgen_ps3_res_3x3", (1, 362, 722, 128, 3, 3, 128)),
    ("nextgen_head_ps_3x3", (1, 362, 722, 256, 3, 3, 256)),
    ("camulator_ps1_3x3", (1, 52, 92, 1024, 3, 3, 2048)),
    ("camulator_ps2_3x3", (1, 102, 182, 1024, 3, 3, 1024)),
    ("camulator_ps3_3x3", (1, 202, 362, 512, 3, 3, 512)),
    ("camulator_head_ps_3x3", (1, 402, 722, 256, 3, 3, 256)),
    ("camulator_sharp_3x3", (1, 802, 1442, 64, 3, 3, 64)),
    ("diffusion_stage0_embed_8x8", (1, 415, 735, 496, 8, 8, 176))]
# main path 15 (phase 18b): CONF_025_TRAIN at domain 2, each rank's
# latitude slab of the 800 padded rows (400 a rank) extended by its halo:
# the stage-0 quadrant embed's 15 rows a side (430 rows, 215 after
# space-to-depth), the stage 1-3 embeds' one row, the UpBlocks' 3x3
# residual convs and the head's phase conv one row a side
SLAB_CONV_SHAPES = [
    ("slab_stage0_embed_8x8", (1, 215, 735, 240, 8, 8, 176)),
    ("slab_stage1_embed_2x2", (1, 101, 361, 512, 2, 2, 256)),
    ("slab_stage2_embed_2x2", (1, 51, 181, 1024, 2, 2, 512)),
    ("slab_stage3_embed_2x2", (1, 26, 91, 2048, 2, 2, 1024)),
    ("slab_up1_res_3x3", (1, 52, 182, 512, 3, 3, 512)),
    ("slab_up2_res_3x3", (1, 102, 362, 256, 3, 3, 256)),
    ("slab_up3_res_3x3", (1, 202, 722, 128, 3, 3, 128)),
    ("slab_head_phase_3x3", (1, 202, 722, 256, 3, 3, 224))]
# main path 15 (phase 18b, fuxi_domain2): CONF_FUXI at domain 2, each
# rank's 100 of the 200 embedded rows: the DownBlock's 3x3/s2 conv on its
# slab extended by a row a side (102x322, 51x161 after space-to-depth, the
# kernel zero-extended to 4x4), its residual convs at 50 rows (52x162 with
# the halo) and the UpBlock's at 100 (102x322)
FUXI_SLAB_CONV_SHAPES = [
    ("slab_fuxi_down_s2d_2x2", (1, 51, 161, 4096, 2, 2, 1024)),
    ("slab_fuxi_down_res_3x3", (1, 52, 162, 1024, 3, 3, 1024)),
    ("slab_fuxi_up_res_3x3", (1, 102, 322, 1024, 3, 3, 1024))]
# main path 15 (phase 18e): NextGen at CONF_NEXTGEN's widths on 640x1280
# (`ng_domain2`), each rank's 320 rows: the stage-0 quadrant embed on the
# slab extended by 15 rows a side (350x1310, 175x655 after space-to-depth)
# and the head's sub-pixel conv on the stage-0 slab of 160 rows with a row
# a side (162x642); the U-Net (`unet_domain2`, f32) at 721x1440 padded to
# 728x1440: its level-0 3x3 convs on 364 rows with a row a side
NG_SLAB_CONV_SHAPES = [
    ("ng640_slab_stage0_embed_8x8", (1, 175, 655, 240, 8, 8, 176)),
    ("ng640_slab_head_ps_3x3", (1, 162, 642, 256, 3, 3, 256))]
UNET_SLAB_CONV_SHAPES = [("unet_slab_enc0_3x3", (1, 366, 1442, 64, 3, 3, 64))]


def unet_conv_shapes(conf: dict, dims=(64, 128, 256, 512)):
    """The U-Net's (models/unet.py, f32) distinct 3x3 convs unsharded on
    `conf`'s grid padded to a multiple of 8: the encoder's two a level
    (inputs to dims[0], then dims[i - 1] to dims[i]; level i at the padded
    grid >> i) and the decoder's two at levels 2-0 (the skip concat's 2 d
    to d, d to d), each on its input padded a row and a column a side;
    and their input gradients (`_dx`: gy padded by 2 a side, Cin and Cout
    swapped), for every conv but the first, whose input is the batch.
    (label, (n, hp, wp, cin, kh, kw, cout)) in two lists."""
    mult = 2 ** (len(dims) - 1)
    h, w = -(-conf["image_height"] // mult) * mult, -(-conf["image_width"] // mult) * mult
    c = (conf["channels"] * conf["levels"] + conf["surface_channels"]
         + conf["input_only_channels"]) * conf["frames"]
    convs = []
    for i, d in enumerate(dims):
        convs += [(i, c, d), (i, d, d)]
        c = d
    for i in reversed(range(len(dims) - 1)):
        convs += [(i, 2 * dims[i], dims[i]), (i, dims[i], dims[i])]
    fwd, dx = {}, {}
    for j, (i, ci, co) in enumerate(convs):
        hp, wp = (h >> i) + 2, (w >> i) + 2
        fwd.setdefault((i, ci, co), (f"unet_l{i}_{ci}to{co}_3x3", (1, hp, wp, ci, 3, 3, co)))
        if j:
            dx.setdefault((i, co, ci), (f"unet_l{i}_{ci}to{co}_3x3_dx",
                                        (1, hp + 2, wp + 2, co, 3, 3, ci)))
    return list(fwd.values()), list(dx.values())
# main path 16 (phase 19): the published layouts at 640x1280 padded 80 a
# side to 800x1440. wxformer_6h: the stage-0 embed over 74 inputs (296 after
# space-to-depth: five 64-deep K steps a tap, the last part zero-filled by
# TMA, against 240's four) and the head's phase conv to 71 outputs (284
# phases); its other convs are main path 1's. fuxi_6h: the DownBlock's
# conv, its residual convs and the UpBlock's at 1440 columns (CONF_FUXI's
# 1280: 181 / 182 / 362 wide against 161 / 162 / 322)
APP_CONV_SHAPES = [
    ("wx6h_stage0_embed_8x8", (1, 415, 735, 296, 8, 8, 176)),
    ("wx6h_head_phase_3x3", (1, 402, 722, 256, 3, 3, 284)),
    ("fx6h_down_s2d_2x2", (1, 101, 181, 4096, 2, 2, 1024)),
    ("fx6h_down_res_3x3", (1, 102, 182, 1024, 3, 3, 1024)),
    ("fx6h_up_res_3x3", (1, 202, 362, 1024, 3, 3, 1024))]
# main path 15 (phase 18e): the U-Net's reference step, unsharded at 721x1440
UNET_CONV_SHAPES = unet_conv_shapes({"image_height": 721, "image_width": 1440,
                                     **{k: CONF_025_TRAIN[k] for k in (
                                         "frames", "levels", "channels", "surface_channels",
                                         "input_only_channels")}})
CONV_SHAPES = [
    ("stage0_embed_8x8", (1, 415, 735, 240, 8, 8, 176), BOTH, 10),
    # ic-opt's input gradient of the stage-0 embed (main path 14): gy
    # padded by 7 on each side, the kernel flipped, 176 -> 240
    ("stage0_embed_8x8_dx", (1, 422, 742, 176, 8, 8, 240), BF16, 3),
    ("head_phase_3x3", (1, 402, 722, 256, 3, 3, 224), BOTH, 10),
    ("stage1_embed_2x2", (1, 201, 361, 512, 2, 2, 256), BF16, 10),
    ("stage2_embed_2x2", (1, 101, 181, 1024, 2, 2, 512), BF16, 10),
    ("stage3_embed_2x2", (1, 51, 91, 2048, 2, 2, 1024), BF16, 10),
    ("up1_res_3x3", (1, 102, 182, 512, 3, 3, 512), BF16, 10),
    ("up2_res_3x3", (1, 202, 362, 256, 3, 3, 256), BF16, 10),
    ("up3_res_3x3", (1, 402, 722, 128, 3, 3, 128), BF16, 10),
    ("fuxi_down_s2d_2x2", (1, 101, 161, 4096, 2, 2, 1024), BOTH, 3),
    ("fuxi_down_res_3x3", (1, 102, 162, 1024, 3, 3, 1024), BOTH, 3),
    ("fuxi_up_res_3x3", (1, 202, 322, 1024, 3, 3, 1024), BOTH, 3),
    ("bench_embed_16x16", (1, 415, 735, 240, 16, 16, 128), BOTH, 3),
    ("skebs_cnn_3x3", (2, 723, 1442, 60, 3, 3, 13), F32, 5),
    ("ragged_channels_3x3", (1, 130, 250, 100, 3, 3, 60), BF16, 10),
    ("tall_3x2", (1, 130, 250, 128, 3, 2, 128), BF16, 10),
    *[(label, shape, BF16, 3) for label, shape in NEW_CONV_SHAPES],
    *[(label, shape, BF16, 5) for label, shape in SLAB_CONV_SHAPES],
    *[(label, shape, BF16, 3) for label, shape in FUXI_SLAB_CONV_SHAPES],
    *[(label, shape, BF16, 5) for label, shape in APP_CONV_SHAPES],
    *[(label, shape, BF16, 5) for label, shape in NG_SLAB_CONV_SHAPES],
    *[(label, shape, F32, 3) for label, shape in UNET_SLAB_CONV_SHAPES],
    *[(label, shape, F32, 3) for part in UNET_CONV_SHAPES for label, shape in part]]


def conv_cases(torch, g):
    import torch.nn.functional as F

    from credit_torch.ops import cuda_conv

    res = {}
    for label, (n, hp, wp, cin, kh, kw, cout), dtypes, iters in CONV_SHAPES:
        # f32: an output sums kh*kw*cin products
        f32_tol = f32_limit(kh * kw * cin)
        for name in dtypes:
            dt, tol = (torch.bfloat16, 1e-2) if name == "bfloat16" else (torch.float32, f32_tol)
            x = (torch.randn((n, hp, wp, cin), generator=g, device="cuda") * 0.5).to(dt)
            k = (torch.randn((kh, kw, cin, cout), generator=g, device="cuda")
                 / math.sqrt(kh * kw * cin)).to(dt)
            xn = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
            kn = k.permute(3, 2, 0, 1).contiguous()
            ho, wo = hp - kh + 1, wp - kw + 1
            isz = x.element_size()
            r = check_case(f"conv2d_valid {label}", name,
                           lambda: cuda_conv.conv2d_valid(x, k),
                           lambda: cuda_conv.conv2d_valid_plain(x, k),
                           lambda: F.conv2d(xn, kn),
                           (x.numel() + k.numel() + n * ho * wo * cout) * isz,
                           2.0 * n * ho * wo * kh * kw * cin * cout, tol, iters,
                           "3xtf32" if dt == torch.float32 else None)
            res[(label, dt)] = r
            if dt == torch.float32:  # 3xTF32: the kernel and the others against f64 sums
                check_f64(f"conv2d_valid {label}", conv_valid_f64(torch, x, k),
                          {"kernel": lambda: cuda_conv.conv2d_valid(x, k),
                           "plain": lambda: cuda_conv.conv2d_valid_plain(x, k),
                           "cuDNN": lambda: F.conv2d(xn, kn).permute(0, 2, 3, 1)}, f32_tol)
    return res


def conv_valid_f64(torch, x, k):
    """The VALID conv with f64 sums (one f64 GEMM per tap)."""
    n, hp, wp, _ = x.shape
    kh, kw, _, cout = k.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    xd, kd = x.double(), k.double()
    out = torch.zeros((n, ho, wo, cout), dtype=torch.float64, device=x.device)
    for di in range(kh):
        for dj in range(kw):
            out += xd[:, di:di + ho, dj:dj + wo, :] @ kd[di, dj]
    return out


def conv_wgrad_f64(torch, x, gy, kh, kw):
    """The weight gradient with f64 sums (one f64 GEMM per tap)."""
    n, hp, wp, cin = x.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    xd, gd = x.double(), gy.double().reshape(-1, gy.shape[-1])
    return torch.stack([xd[:, di:di + ho, dj:dj + wo, :].reshape(-1, cin).T @ gd
                        for di in range(kh) for dj in range(kw)]).reshape(kh, kw, cin, -1)


# (label, (h, w, C), post-norm, hidden) of the FF and its backward
FF_SHAPES = [("stage0_C128", (400, 720, 128), False, 512),
             ("stage1_C256", (200, 360, 256), False, 1024),
             ("stage2_C512", (100, 180, 512), False, 2048),
             ("stage3_C1024", (50, 90, 1024), False, 4096),
             ("fuxi_C1024_post", (105, 161, 1024), True, 4096),
             # fuxi_6h's (main path 16): 100x180 tokens padded to 105x182
             ("fx6h_C1024_post", (105, 182, 1024), True, 4096),
             # CONF_FUXI's window slabs at domain 2 (main path 15): 8 and 7
             # of the 15 window rows
             ("slab_fuxi_C1024_post_56", (56, 161, 1024), True, 4096),
             ("slab_fuxi_C1024_post_49", (49, 161, 1024), True, 4096),
             ("padded_C192_post", (100, 180, 192), True, 768),
             ("wide_C1152", (50, 90, 1152), False, 4608),
             ("wide_C1152_post", (50, 90, 1152), True, 4608),
             ("wide_C2304", (20, 45, 2304), False, 9216),
             ("ragged_C100_H404_post", (100, 180, 100), True, 404)]


# FF cases timed on both bf16 routes in turns on one card (fused, split,
# split, fused): the widths both routes take
FF_TURNS = ("stage0_C128", "stage1_C256", "padded_C192_post")
# bf16 FF cases whose fused kernel is also checked bitwise on a second call
FF_REPEAT = ("stage0_C128", "padded_C192_post")


def ff_composition(torch, x, prm, post):
    """The FF as PyTorch's own calls compose it (layer norm, two linears,
    GELU, the residual): a yardstick for the kernel's time, as no single
    PyTorch call computes it; the port never calls it."""
    import torch.nn.functional as F

    g, b, w1, b1, w2, b2 = prm
    c = x.shape[-1]
    if post:
        h = F.linear(F.gelu(F.linear(x, w1.t(), b1)), w2.t(), b2)
        return x + F.layer_norm(h, (c,), g, b)
    y = F.layer_norm(x, (c,), g, b)
    return x + F.linear(F.gelu(F.linear(y, w1.t(), b1)), w2.t(), b2)


def ff_composition_bwd(torch, x, ct, prm, post):
    """PyTorch's own backward of `ff_composition` at x with cotangent ct:
    autograd through the saved activations of one forward run, a yardstick
    for kernel 4's time (no single PyTorch call computes it; the kernel
    recomputes h1, and post-norm o2, where autograd saved them). Returns a
    function that runs the backward once; the port never calls it."""
    leaves = [t.detach().clone().requires_grad_() for t in [x, *prm]]
    with torch.enable_grad():
        out = ff_composition(torch, leaves[0], leaves[1:], post)

    def run():
        with torch.enable_grad():
            return torch.autograd.grad(out, leaves, ct, retain_graph=True)
    return run


def ff_cases(torch, g):
    from credit_torch.ops import cuda_ff
    from credit_torch.tools import cuda_ms

    res = {}
    # pre-norm at the WXFormer's stages; post-norm at FuXi's SwinV2 stage
    # (105x161 tokens after the window pad) and at C = 192, which the bf16
    # kernel pads to 256: the padded columns must stay out of the LN. Beyond
    # the paths: C = 1152 (> 1024) in both forms, and C = 100 with hidden
    # 404 (neither a multiple of 8: the wrapper pads). bf16 from C = 256 on
    # and at ragged widths takes the split route, whose plain version is its
    # passes (cuda_ff.fused_ff_split_plain); f32 past 1024 the passes
    for label, (h, w, c), post, hd in FF_SHAPES:
        for dt, tol in [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)]:
            x = torch.randn((1, h, w, c), generator=g, device="cuda").to(dt)
            prm = [1 + 0.1 * torch.randn(c, generator=g, device="cuda"),
                   0.1 * torch.randn(c, generator=g, device="cuda"),
                   torch.randn((c, hd), generator=g, device="cuda") / math.sqrt(c),
                   0.02 * torch.randn(hd, generator=g, device="cuda"),
                   torch.randn((hd, c), generator=g, device="cuda") / math.sqrt(hd),
                   0.02 * torch.randn(c, generator=g, device="cuda")]
            prm = [p.to(dt) for p in prm]
            m = h * w
            isz = x.element_size()
            route = cuda_ff.ff_plan(m, c, hd, dt, post).route
            plain = cuda_ff.fused_ff_split_plain if route == "split" else cuda_ff.fused_ff_plain
            comp_ms = cuda_ms(lambda: ff_composition(torch, x, prm, post), 10)
            log(f"  fused_ff {label} [{str(dt).split('.')[1]}] route {route}, "
                f"composition_ms {comp_ms:.4f} (layer_norm + linear + gelu + linear + add)")
            r = check_case(f"fused_ff {label}", str(dt).split(".")[1],
                           lambda: cuda_ff.fused_ff(x, *prm, post_norm=post),
                           lambda: plain(x, *prm, post_norm=post),
                           None,
                           (2 * m * c + 2 * c * hd + 3 * c + hd) * isz,
                           4.0 * m * c * hd, tol, 10)
            r["composition_ms"] = comp_ms
            if dt != torch.bfloat16:
                res[(label, dt)] = r
                continue
            if label in FF_REPEAT:
                first = cuda_ff.fused_ff(x, *prm, post_norm=post)
                if not torch.equal(first, cuda_ff.fused_ff(x, *prm, post_norm=post)):
                    raise AssertionError(f"fused_ff {label}: two calls differ")
                log(f"    {route} route bit-identical on a second call; "
                    f"{4.0 * m * c * hd / r['ms'] / 1e9:.1f} TFLOP/s")
            if label in FF_TURNS:
                # the fused kernel against the split route on this card, in
                # turns: fused, split, split, fused
                turns = [(rt, cuda_ms(lambda: cuda_ff.fused_ff(x, *prm, post_norm=post,
                                                               route=rt), 10))
                         for rt in ("fused", "split", "split", "fused")]
                err = (cuda_ff.fused_ff(x, *prm, post_norm=post, route="fused").float()
                       - plain(x, *prm, post_norm=post).float()).abs().max().item()
                fused_ms = [ms for rt, ms in turns if rt == "fused"]
                log(f"    routes in turns: " + ", ".join(f"{rt} {ms:.4f}" for rt, ms in turns)
                    + f" ms; the fused kernel's max_abs_err {err:.3e}, "
                    f"{4.0 * m * c * hd / min(fused_ms) / 1e9:.1f} TFLOP/s, against bound "
                    f"{r['bound_ms']:.4f} and composition {comp_ms:.4f} ms")
                r["turns_ms"] = turns
            res[(label, dt)] = r
    return res


# (label, (h, w, C), post-norm, this rank's hidden width) of the FF split
# over 2 tp ranks (main path 15, phase 18(d)): CONF_025's four stages and
# CONF_FUXI's SwinV2 MLP at hidden / 2
FF_TP_SHAPES = [("tp2_stage0_C128", (400, 720, 128), False, 256),
                ("tp2_stage1_C256", (200, 360, 256), False, 512),
                ("tp2_stage2_C512", (100, 180, 512), False, 1024),
                ("tp2_stage3_C1024", (50, 90, 1024), False, 2048),
                ("tp2_fuxi_C1024_post", (105, 161, 1024), True, 2048)]


def ff_partial_composition(torch, y, w1, b1, w2, post):
    """One rank's partial as PyTorch's own calls compose it (layer norm
    (pre-norm), linear, GELU, linear without bias): a yardstick for
    ff_partial's time; the port never calls it. y is x and the LN's
    parameters, (x, g, b)."""
    import torch.nn.functional as F

    x, g, b = y
    a = x if post else F.layer_norm(x, (x.shape[-1],), g, b)
    return F.linear(F.gelu(F.linear(a, w1.t(), b1)), w2.t())


def ff_tp_cases(torch, g):
    """The tp entry points at the per-rank shapes (FF_TP_SHAPES), bf16 and
    f32, each against its plain version: ff_partial on rank 0's slice,
    ff_finish on the two ranks' summed partials, ff_finish_bwd, and
    ff_partial_bwd from its dz; the two ranks through ff_finish against
    fused_ff on the whole weights; beside each, PyTorch's composition of
    the same sliced products (forward, and autograd through it)."""
    from credit_torch.ops import cuda_ff
    from credit_torch.tools import cuda_ms

    res = {}
    for label, (h, w, c), post, hd in FF_TP_SHAPES:
        for dt, tol in [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)]:
            name = str(dt).split(".")[1]
            x = torch.randn((1, h, w, c), generator=g, device="cuda").to(dt)
            ct = (0.1 * torch.randn((1, h, w, c), generator=g, device="cuda")).to(dt)
            whole = [1 + 0.1 * torch.randn(c, generator=g, device="cuda"),
                     0.1 * torch.randn(c, generator=g, device="cuda"),
                     torch.randn((c, 2 * hd), generator=g, device="cuda") / math.sqrt(c),
                     0.02 * torch.randn(2 * hd, generator=g, device="cuda"),
                     torch.randn((2 * hd, c), generator=g, device="cuda") / math.sqrt(2 * hd),
                     0.02 * torch.randn(c, generator=g, device="cuda")]
            gm, bt, w1, b1, w2, b2 = [p.to(dt) for p in whole]
            ranks = [(w1[:, r * hd:(r + 1) * hd].contiguous(), b1[r * hd:(r + 1) * hd],
                      w2[r * hd:(r + 1) * hd].contiguous()) for r in range(2)]
            mine = (gm, bt, *ranks[0])
            m, isz = h * w, x.element_size()
            pbytes = (2 * c * hd + 2 * c + hd) * isz
            iters, comp, comp_bwd = 3, None, None
            if dt == torch.bfloat16:  # the paths' dtype: timed beside PyTorch's composition
                iters = 5
                comp = cuda_ms(lambda: ff_partial_composition(torch, (x, gm, bt), *ranks[0],
                                                              post), 5)
                leaves = [t.detach().clone().requires_grad_() for t in (x, gm, bt, *ranks[0])]
                with torch.enable_grad():
                    zc = ff_partial_composition(torch, leaves[:3], *leaves[3:], post)
                    comp_bwd = cuda_ms(lambda: torch.autograd.grad(
                        zc, leaves, ct.to(zc.dtype), retain_graph=True, allow_unused=post), 5)
                del zc, leaves
                log(f"  ff tp {label} [{name}] rank hidden {hd}: composition_ms {comp:.4f}, "
                    f"composition_backward_ms {comp_bwd:.4f} (the same sliced products)")
            r = check_case(f"ff_partial {label}", name,
                           lambda: cuda_ff.ff_partial(x, *mine, post_norm=post),
                           lambda: cuda_ff.ff_partial_plain(x, *mine, post),
                           None, m * c * (isz + 4) + pbytes, 4.0 * m * c * hd, tol, iters)
            res[("ff_partial", label, dt)] = {**r, "composition_ms": comp}
            z = sum(cuda_ff.ff_partial(x, gm, bt, *rk, post_norm=post) for rk in ranks)
            r = check_case(f"ff_finish {label}", name,
                           lambda: cuda_ff.ff_finish(x, z, gm, bt, b2, post_norm=post),
                           lambda: cuda_ff.ff_finish_plain(x, z, gm, bt, b2, post),
                           None, m * c * (2 * isz + 4) + 3 * c * isz, 10.0 * m * c, tol,
                           iters)
            res[("ff_finish", label, dt)] = r
            r = check_case(f"ff_finish_bwd {label}", name,
                           lambda: [t for t in cuda_ff.ff_finish_bwd(z, ct, gm, bt, b2,
                                                                      post_norm=post)
                                    if t is not None],
                           lambda: [t for t in cuda_ff.ff_finish_bwd_plain(z, ct, gm, bt, b2,
                                                                            post)
                                    if t is not None],
                           None, m * c * ((4 + 2 * isz) if post else isz) + 5 * c * 4,
                           10.0 * m * c, tol, iters)
            res[("ff_finish_bwd", label, dt)] = r
            dz = cuda_ff.ff_finish_bwd(z, ct, gm, bt, b2, post_norm=post)[0]
            r = check_case(f"ff_partial_bwd {label}", name,
                           lambda: cuda_ff.ff_partial_bwd(x, dz, *mine, post_norm=post),
                           lambda: cuda_ff.ff_partial_bwd_plain(x, dz, *mine, post),
                           None, 3 * m * c * isz + pbytes + (2 * c * hd + 2 * c + hd) * 4,
                           10.0 * m * c * hd, tol, iters)
            res[("ff_partial_bwd", label, dt)] = {**r, "composition_ms": comp_bwd}
            got = cuda_ff.ff_finish(x, z, gm, bt, b2, post_norm=post)
            want = cuda_ff.fused_ff(x, gm, bt, w1, b1, w2, b2, post_norm=post)
            err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            log(f"    two ranks' ff_partial summed through ff_finish against fused_ff on the "
                f"whole weights: {err:.3e} of the largest value (limit {tol:g})")
            if not err <= tol:
                raise AssertionError(f"ff tp {label} [{name}]: the ranks' sum disagrees with "
                                     "fused_ff")
            del x, ct, z, dz, got, want
    return res


def attention_cases(torch, g):
    import torch.nn.functional as F

    from credit_torch.ops import cuda_attention

    res = {}
    # stage-0 local windows (T=100, 4 heads), stage-1 and stage-3 local
    # windows (8 and 32 heads: 2 and 8 head groups an item), stage-1 long
    # windows (T=25), stage-3 long windows (T=1, packs of 16); q, k, v are
    # views of one fused qkv projection. Beyond the paths: 12x12 windows
    # (T = 144) and 24x24 windows at heads of 64 (T = 576, past what one
    # block of keys in shared memory holds) run the online softmax over key
    # blocks in bf16 (2e-2: p is rounded before the division) and the FMA
    # kernel in f32; heads of 128
    for label, (nwin, t, heads, dh) in [("stage0_T100", (2880, 100, 4, 32)),
                                        ("stage1_T100", (720, 100, 8, 32)),
                                        ("stage3_T100", (45, 100, 32, 32)),
                                        ("stage1_T25", (2880, 25, 8, 32)),
                                        ("stage3_T1", (4500, 1, 32, 32)),
                                        ("window12_T144", (2000, 144, 4, 32)),
                                        ("window24_T576", (500, 576, 4, 64)),
                                        ("head128_T100", (2880, 100, 2, 128))]:
        for dt, tol in [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)]:
            inner = heads * dh
            qkv = torch.randn((1, nwin, t, 3 * inner), generator=g, device="cuda").to(dt)
            q, k, v = qkv.split(inner, dim=-1)
            bias = torch.randn((t, t), generator=g, device="cuda")

            def heads_first(z):
                return z.reshape(nwin, t, heads, dh).transpose(1, 2).contiguous()

            qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
            mask = bias.to(dt)
            isz = q.element_size()
            r = check_case(f"fused_window_attention {label}", str(dt).split(".")[1],
                           lambda: cuda_attention.fused_window_attention(q, k, v, bias, heads),
                           lambda: cuda_attention.fused_window_attention_plain(q, k, v, bias,
                                                                               heads),
                           lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
                           4 * nwin * t * inner * isz + t * t * 4,
                           4.0 * nwin * heads * t * t * dh, tol, 3 if t > 128 else 10)
            res[(label, dt)] = r
    return res[("stage0_T100", torch.bfloat16)]


def ff_bwd_cases(torch, g):
    from credit_torch.ops import cuda_ff
    from credit_torch.tools import cuda_ms

    res = {}
    for label, (h, w, c), post, hd in FF_SHAPES:
        # bf16: dx is rounded once at the end, and y, a, ct, do2 and dh1
        # enter the products rounded in both versions, so a flipped rounding
        # moves dx by about an ulp; f32: summation order over up to 288000
        # rows. Post-norm recomputes o2 = a.w2 as well: 12 M C H operations
        for dt, tol in [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)]:
            x = torch.randn((1, h, w, c), generator=g, device="cuda").to(dt)
            ct = (0.1 * torch.randn((1, h, w, c), generator=g, device="cuda")).to(dt)
            prm = [1 + 0.1 * torch.randn(c, generator=g, device="cuda"),
                   0.1 * torch.randn(c, generator=g, device="cuda"),
                   torch.randn((c, hd), generator=g, device="cuda") / math.sqrt(c),
                   0.02 * torch.randn(hd, generator=g, device="cuda"),
                   torch.randn((hd, c), generator=g, device="cuda") / math.sqrt(hd),
                   0.02 * torch.randn(c, generator=g, device="cuda")]
            prm = [p.to(dt) for p in prm]
            m = h * w
            isz = x.element_size()
            name = str(dt).split(".")[1]
            comp_ms = cuda_ms(ff_composition_bwd(torch, x, ct, prm, post), 10)
            log(f"  fused_ff_bwd {label} [{name}] composition_backward_ms {comp_ms:.4f} "
                "(autograd of layer_norm + linear + gelu + linear + add)")
            r = check_case(f"fused_ff_bwd {label}", name,
                           lambda: cuda_ff.fused_ff_bwd(x, ct, *prm, post_norm=post),
                           lambda: cuda_ff.fused_ff_bwd_plain(x, ct, *prm, post_norm=post),
                           None,
                           3 * m * c * isz + (2 * c * hd + 3 * c + hd) * (isz + 4),
                           (12.0 if post else 10.0) * m * c * hd, tol, 10)
            r["composition_ms"] = comp_ms
            if dt == torch.bfloat16:
                # the weight gradients' row splits and every partial are
                # summed in a fixed order: a second call gives the same bits
                first = cuda_ff.fused_ff_bwd(x, ct, *prm, post_norm=post)
                second = cuda_ff.fused_ff_bwd(x, ct, *prm, post_norm=post)
                if not all(torch.equal(a, b) for a, b in zip(first, second)):
                    raise AssertionError(f"fused_ff_bwd {label}: two calls differ")
                log(f"    a second call is bitwise equal to the first "
                    f"({cuda_ff.ffb_plan(m, c, hd, post)})")
            res[(label, dt)] = r
    return res


# kernel 5's shapes: every weight gradient the training steps launch (the
# stage-0 embed's 8x8 after space-to-depth, the stage 1-3 embeds' 2x2, the
# UpBlocks' 3x3 residual convs, the training head's 3x3 phase conv; FuXi's
# three conv shapes; SKEBS's backscatter net, 2 members), and the ragged and
# tall cases of CONV_SHAPES
WGRAD_SHAPES = [
    ("stage0_embed_8x8", (1, 415, 735, 240, 8, 8, 176), BOTH, 5),
    ("stage1_embed_2x2", (1, 201, 361, 512, 2, 2, 256), BOTH, 5),
    ("stage2_embed_2x2", (1, 101, 181, 1024, 2, 2, 512), BOTH, 5),
    ("stage3_embed_2x2", (1, 51, 91, 2048, 2, 2, 1024), BOTH, 5),
    ("up1_res_3x3", (1, 102, 182, 512, 3, 3, 512), BF16, 5),
    ("up2_res_3x3", (1, 202, 362, 256, 3, 3, 256), BF16, 5),
    ("up3_res_3x3", (1, 402, 722, 128, 3, 3, 128), BF16, 5),
    ("head_phase_3x3", (1, 402, 722, 256, 3, 3, 256), BOTH, 5),
    ("fuxi_down_s2d_2x2", (1, 101, 161, 4096, 2, 2, 1024), BOTH, 3),
    ("fuxi_down_res_3x3", (1, 102, 162, 1024, 3, 3, 1024), BOTH, 3),
    ("fuxi_up_res_3x3", (1, 202, 322, 1024, 3, 3, 1024), BOTH, 3),
    ("skebs_cnn_3x3", (2, 723, 1442, 60, 3, 3, 13), F32, 5),
    ("ragged_channels_3x3", (1, 130, 250, 100, 3, 3, 60), BF16, 5),
    ("tall_3x2", (1, 130, 250, 128, 3, 2, 128), BF16, 5),
    *[(label, shape, BF16, 3) for label, shape in NEW_CONV_SHAPES],
    *[(label, shape[:6] + (256 if "head" in label else shape[6],), BF16, 5)
      for label, shape in SLAB_CONV_SHAPES],
    *[(label, shape, BF16, 3) for label, shape in FUXI_SLAB_CONV_SHAPES],
    *[(label, shape, BF16, 3) for label, shape in NG_SLAB_CONV_SHAPES],
    *[(label, shape, F32, 3) for label, shape in UNET_SLAB_CONV_SHAPES],
    *[(label, shape, F32, 3) for label, shape in UNET_CONV_SHAPES[0]]]


def wgrad_cases(torch, g):
    from credit_torch.ops import cuda_conv

    res = {}
    # both versions sum exact products of the same values in f32 over up to
    # ~300000 pixels, in other orders; the bf16 kernel's fixed-order split
    # sum gives the same bits on every call
    for label, (n, hp, wp, cin, kh, kw, cout), dtypes, iters in WGRAD_SHAPES:
        for name in dtypes:
            dt, tol = (torch.bfloat16, 5e-4) if name == "bfloat16" else (torch.float32, 5e-4)
            ho, wo = hp - kh + 1, wp - kw + 1
            x = (torch.randn((n, hp, wp, cin), generator=g, device="cuda") * 0.5).to(dt)
            gy = (torch.randn((n, ho, wo, cout), generator=g, device="cuda") * 0.1).to(dt)
            xn, gyn = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)  # NCHW views
            isz = x.element_size()
            r = check_case(f"conv2d_wgrad {label}", name,
                           lambda: cuda_conv.conv2d_wgrad(x, gy, kh, kw),
                           lambda: cuda_conv.conv2d_wgrad_plain(x, gy, kh, kw),
                           lambda: torch.nn.grad.conv2d_weight(xn, (cout, cin, kh, kw), gyn),
                           (x.numel() + gy.numel()) * isz + kh * kw * cin * cout * 4,
                           2.0 * n * ho * wo * kh * kw * cin * cout, tol, iters,
                           "3xtf32" if dt == torch.float32 else None)
            if not torch.equal(cuda_conv.conv2d_wgrad(x, gy, kh, kw),
                               cuda_conv.conv2d_wgrad(x, gy, kh, kw)):
                raise AssertionError(f"conv2d_wgrad {label} [{name}]: two calls differ")
            if dt == torch.float32:
                # 5e-4 against the plain version cannot tell 3xTF32 from
                # TF32: against f64 sums an output sums its n*ho*wo pixels'
                # products, held to phase 2's f32 limit for that count
                check_f64(f"conv2d_wgrad {label}", conv_wgrad_f64(torch, x, gy, kh, kw),
                          {"kernel": lambda: cuda_conv.conv2d_wgrad(x, gy, kh, kw),
                           "plain": lambda: cuda_conv.conv2d_wgrad_plain(x, gy, kh, kw),
                           "cuDNN": lambda: torch.nn.grad.conv2d_weight(
                               xn, (cout, cin, kh, kw), gyn).permute(2, 3, 1, 0)},
                          f32_limit(n * ho * wo))
            res[(label, dt)] = r
    return res


def probe_cases(torch, g):
    """The tools' kernels: the two row-band conv drafts at the probes' 8x8
    shape in bands of the tools' default 24 rows (tolerances as kernel 2's),
    and the identity copy of the stage-0 embed's output (bit-exact)."""
    import torch.nn.functional as F

    from credit_torch.ops import cuda_probes

    res = {}
    n, hp, wp, cin, kh, cout = 1, 415, 735, 240, 8, 176
    ho, wo = hp - kh + 1, wp - kh + 1
    for form, kernel_fn, plain_fn in [("dma", cuda_probes.conv_band_dma,
                                       cuda_probes.conv_band_dma_plain),
                                      ("halo", cuda_probes.conv_band_halo,
                                       cuda_probes.conv_band_halo_plain)]:
        for dt, tol, iters in [(torch.bfloat16, 1e-2, 10), (torch.float32, 1e-5, 3)]:
            x = (torch.randn((n, hp, wp, cin), generator=g, device="cuda") * 0.5).to(dt)
            k = (torch.randn((kh, kh, cin, cout), generator=g, device="cuda")
                 / math.sqrt(kh * kh * cin)).to(dt)
            xn, kn = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous()
            r = check_case(f"conv_band {form} t24 stage0_embed_8x8", str(dt).split(".")[1],
                           lambda: kernel_fn(x, k, 24), lambda: plain_fn(x, k, 24),
                           lambda: F.conv2d(xn, kn),
                           (x.numel() + k.numel() + n * ho * wo * cout) * x.element_size(),
                           2.0 * n * ho * wo * kh * kh * cin * cout, tol, iters)
            res[(form, dt)] = r
    y = torch.randn((1, 400, 720, 128), generator=g, device="cuda").to(torch.bfloat16)
    out = torch.empty_like(y)
    res["copy"] = check_case("copy stage0_embed_out", "bfloat16", lambda: cuda_probes.copy(y),
                             lambda: cuda_probes.copy_plain(y), lambda: out.copy_(y),
                             2 * y.numel() * y.element_size(), 0.0, 0.0, 20)
    return res


def tiny_agreement(torch, model_conf: dict, data: dict):
    """A tiny model on the card (kernels) against itself on the CPU (plain
    versions, which the CPU tests hold against the JAX package); its
    `frames` input frames are the rollout's and the train step's history."""
    from credit_torch.convert_jax import init_folded
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.rollout import make_scan_rollout

    conf = {"model": model_conf, "data": data}
    frames = model_conf["frames"]
    schema = ChannelSchema.from_config(conf)
    cpu = init_folded(conf, torch.Generator().manual_seed(1), device="cpu")
    gpu = init_folded(conf, torch.Generator().manual_seed(1), device="cuda")
    x0 = torch.randn((1, frames, 32, 64, schema.n_input),
                     generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = cpu(x0)
        out = gpu(x0.cuda()).cpu()
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    log(f"  tiny forward f32 card vs CPU: rel err {err:.3e} limit 1e-4")
    if not err <= 1e-4:
        raise AssertionError("tiny forward on the card disagrees with the CPU")
    xr, sr = make_scan_rollout(cpu, schema, 2, history_len=frames, device="cpu")(x0)
    xg, sg = make_scan_rollout(gpu, schema, 2, history_len=frames, device="cuda")(x0)
    err = max(((xg.cpu() - xr).abs().max() / xr.abs().max()).item(),
              ((sg.cpu() - sr).abs().max() / sr.abs().max()).item())
    log(f"  tiny 2-step rollout f32 card vs CPU: rel err {err:.3e} limit 1e-4")
    if not err <= 1e-4:
        raise AssertionError("tiny rollout on the card disagrees with the CPU")
    for dt, tol in [(torch.bfloat16, 5e-2)]:
        with torch.no_grad():
            outb = gpu.to(dt)(x0.cuda().to(dt)).float().cpu()
        err = ((outb - ref).abs().max() / ref.abs().max()).item()
        log(f"  tiny forward bf16 card vs f32 CPU: rel err {err:.3e} limit {tol:g}")
        if not err <= tol:
            raise AssertionError("tiny bf16 forward on the card is off")
    tiny_training(torch, conf, schema, frames)


def tiny_training(torch, conf, schema, frames: int):
    """Train-mode forward and backward of the tiny model with spectral-norm
    state, and one 2-step make_train_step, on the card (the kernels in
    autograd) against the CPU (plain versions), f32: loss and gradients
    within 1e-4."""
    from credit_torch.convert_jax import init_train
    from credit_torch.losses import WeightedLoss
    from credit_torch.trainers.scheduler import constant
    from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step

    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, frames, 32, 64, schema.n_input), generator=g)
    y = torch.randn((1, 2, 32, 64, schema.n_target), generator=g) * 0.5
    forcing = torch.randn((1, 2, 32, 64, len(schema.dynamic_forcing_indices())), generator=g)
    loss_fn = WeightedLoss(base="mse")
    models, losses, grads = {}, {}, {}
    for dev in ("cpu", "cuda"):
        model = init_train(conf, torch.Generator().manual_seed(4), device=dev).train()
        loss = loss_fn(y[:, :1].to(dev), model(x.to(dev)))
        loss.backward()
        losses[dev] = loss.item()
        grads[dev] = {k: p.grad.cpu() for k, p in model.named_parameters()}
        models[dev] = model
    err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    gmax = max(v.abs().max().item() for v in grads["cpu"].values())
    # a parameter's scale is at least 1e-2 of the largest gradient: some
    # true gradients are zero (a softmax cannot see the DPB output bias)
    gerr = max((grads["cuda"][k] - v).abs().max().item() / max(v.abs().max().item(), 1e-2 * gmax)
               for k, v in grads["cpu"].items())
    log(f"  tiny train-mode loss f32 card vs CPU: rel err {err:.3e}; gradients, worst "
        f"parameter: rel err {gerr:.3e}; limit 1e-4")
    if not (err <= 1e-4 and gerr <= 1e-4):
        raise AssertionError("tiny training forward/backward on the card disagrees with the CPU")
    tiny_training_bf16(torch, conf, x, y, loss_fn, losses["cpu"], grads["cpu"],
                       BF16_TRAIN_LIMITS[conf["model"]["type"]])
    batch = {"x": x, "y": y, "forcing": forcing}
    metrics = {}
    for dev, model in models.items():
        opt = make_optimizer({"trainer": {"grad_max_norm": 1.0, "weight_decay": 0.01}},
                             constant(1e-3))
        step = make_train_step(model, loss_fn, opt, schema, forecast_len=2, history_len=frames,
                               device=dev)
        _, metrics[dev] = step(TrainState.create(model, opt, ema=True), batch)
    err = max(abs(float(metrics["cuda"][k]) - float(metrics["cpu"][k])) / abs(float(metrics["cpu"][k]))
              for k in ("loss", "grad_norm"))
    log(f"  tiny 2-step train step f32 card vs CPU: loss and grad norm rel err {err:.3e} "
        f"limit 1e-4")
    if not err <= 1e-4:
        raise AssertionError("tiny train step on the card disagrees with the CPU")


def tiny_training_bf16(torch, conf, x, y, loss_fn, loss_ref, grads_ref, lims):
    """The same train-mode forward and backward with bf16 compute (f32
    parameters, as in the training paths) on the card, against the f32 CPU
    run: the kernels in bf16 inside autograd, composed. `lims`: loss,
    gradients by norm, worst parameter (BF16_TRAIN_LIMITS)."""
    from credit_torch.convert_jax import init_train

    cb = {**conf, "model": {**conf["model"], "compute_dtype": "bfloat16"}}
    model = init_train(cb, torch.Generator().manual_seed(4), device="cuda").train()
    loss = loss_fn(y[:, :1].cuda(), model(x.cuda()))
    loss.backward()
    grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
    err = abs(loss.item() - loss_ref) / abs(loss_ref)
    num = math.sqrt(sum(((grads[k] - v) ** 2).sum().item() for k, v in grads_ref.items()))
    den = math.sqrt(sum((v ** 2).sum().item() for v in grads_ref.values()))
    gmax = max(v.abs().max().item() for v in grads_ref.values())
    worst = max((grads[k] - v).abs().max().item() / max(v.abs().max().item(), 1e-2 * gmax)
                for k, v in grads_ref.items())
    log(f"  tiny train-mode bf16 card vs f32 CPU: loss rel err {err:.3e} limit {lims[0]:g}; "
        f"gradients, all parameters: rel err {num / den:.3e} limit {lims[1]:g}; worst "
        f"parameter: rel err {worst:.3e} limit {lims[2]:g}")
    if not (err <= lims[0] and num / den <= lims[1] and worst <= lims[2]):
        raise AssertionError("tiny bf16 training forward/backward on the card is off")


def expected_per_step(conf: dict):
    """Kernel launches of one WXFormer forward under the port's routing: one
    FF and one attention per half-block; one VALID conv per cross-embed
    (after space-to-depth the stage-0 quadrant conv is 8x8, the padded 2/4
    embeds 2x2), two 3x3 residual convs per UpBlock (its k2 transpose is a
    1x1 GEMM) and the head's 3x3 phase conv."""
    blocks = sum(conf["depth"])
    return {"fused_ff": 2 * blocks, "fused_ff_split": sum(
                2 * d for dim, d in zip(conf["dim"], conf["depth"]) if _split(dim, False)),
            "fused_window_attention": 2 * blocks, "conv2d_valid": 4 + 3 * 2 + 1}


def _split(dim: int, post_norm: bool) -> bool:
    """Whether a bf16 FF of width dim (hidden 4 dim) takes the split route."""
    import torch

    from credit_torch.ops import cuda_ff

    return cuda_ff.ff_plan(1, dim, 4 * dim, torch.bfloat16, post_norm).route == "split"


def expected_fuxi_per_step(conf: dict):
    """Kernel launches of one FuXi forward: one post-norm FF per SwinV2
    block (the split route at dim 1024; its attention is plain PyTorch: no
    window-attention kernel); five VALID convs, the DownBlock's 3x3/s2 (a 2x2 after space-to-depth)
    and the two residual 3x3 convs of the Down- and UpBlock (the UpBlock's
    k2 transpose is a 1x1 GEMM); the cube embed is a patch GEMM."""
    return {"fused_ff": conf["depth"],
            "fused_ff_split": conf["depth"] if _split(conf["dim"], True) else 0,
            "fused_window_attention": 0, "conv2d_valid": 5}


def expected_train_per_step(fwd: dict, first_conv_needs_gx: bool):
    """Kernel launches of one training step at forecast_len 1: the forward's,
    plus per FF one backward kernel, per conv with kh*kw > 1 one weight
    gradient and one input gradient (kernel 2 again) except for a first
    conv whose input needs none (the WXFormer's stage-0 embed reads the
    batch; FuXi's DownBlock reads the cube embed's output). Attention's
    backward is autograd of its plain version (no kernel)."""
    return {**fwd, "fused_ff_bwd": fwd["fused_ff"], "conv2d_wgrad": fwd["conv2d_valid"],
            "conv2d_valid": 2 * fwd["conv2d_valid"] - (0 if first_conv_needs_gx else 1)}


def _counters():
    """(name, wrapper, attribute) of each launch count: a wrapper adds one
    to its count where it launches its kernel."""
    from credit_torch.ops import cuda_attention, cuda_conv, cuda_ff, cuda_probes

    return [("conv2d_valid", cuda_conv.conv2d_valid, "launches"),
            ("fused_ff", cuda_ff.fused_ff, "launches"),
            ("fused_ff_split", cuda_ff.fused_ff, "split_launches"),
            ("fused_window_attention", cuda_attention.fused_window_attention, "launches"),
            ("fused_ff_bwd", cuda_ff.fused_ff_bwd, "launches"),
            # the FF over tp ranks (kernels 1 and 4 on a rank's hidden slice)
            ("ff_partial", cuda_ff.ff_partial, "launches"),
            ("ff_finish", cuda_ff.ff_finish, "launches"),
            ("ff_partial_bwd", cuda_ff.ff_partial_bwd, "launches"),
            ("ff_finish_bwd", cuda_ff.ff_finish_bwd, "launches"),
            ("conv2d_wgrad", cuda_conv.conv2d_wgrad, "launches"),
            # of kernels 2 and 5's launches, the f32 form's (SUB_COUNTS)
            ("conv2d_valid_f32", cuda_conv.conv2d_valid, "f32_launches"),
            ("conv2d_wgrad_f32", cuda_conv.conv2d_wgrad, "f32_launches"),
            ("conv_band_dma", cuda_probes.conv_band_dma, "launches"),
            ("conv_band_halo", cuda_probes.conv_band_halo, "launches"),
            ("copy", cuda_probes.copy, "launches")]


def _zero_counts() -> None:
    for _, wrapper, attr in _counters():
        setattr(wrapper, attr, 0)


def _read_counts() -> dict:
    return {name: getattr(wrapper, attr) for name, wrapper, attr in _counters()}


# counts that split another count by dtype: the launches a path expects
# are checked on the whole count; the kernels line reads these
SUB_COUNTS = ("conv2d_valid_f32", "conv2d_wgrad_f32")


def _check_counts(counts: dict, want: dict, steps: int) -> None:
    for k in counts:
        if k in SUB_COUNTS:
            continue
        n = want.get(k, 0)
        if counts[k] != n * steps:
            raise AssertionError(f"{k}: {counts[k]} launches, expected {n} x {steps}")


def forecast_setup(conf: dict, seed: int):
    """The forecast's Normalizer and postblocks, seeded: per-variable means
    and spreads (STATS, perturbed per level), 14 monotone hybrid
    coefficients for 13 levels (ak rising from 0, bk from 0 to 1), a
    surface geopotential, and post_conf's tracer, mass, water and energy
    fixers between Denorm and Renorm. Returns (normalizer, blocks, core,
    surface geopotential)."""
    import numpy as np
    import torch

    from credit_torch.data.channels import ChannelSchema
    from credit_torch.data.normalize import Normalizer
    from credit_torch.grid import grid_from_conf
    from credit_torch.physics.core import HybridSigmaPhysics
    from credit_torch.postblock import build_postblocks

    schema = ChannelSchema.from_config(conf)
    rng = np.random.default_rng(seed)
    nlev = schema.n_levels
    mean, std = {}, {}
    for v, (m, s) in STATS.items():
        lev = nlev if v in ("U", "V", "T", "Q") else 1
        mean[v] = m + 0.05 * s * rng.standard_normal(lev)
        std[v] = s * (1 + 0.1 * rng.uniform(size=lev))
    normalizer = Normalizer.from_stats_dict(schema, mean, std)
    ak = np.concatenate([[0.0], np.sort(rng.uniform(0.0, 2e4, nlev))])
    bk = np.concatenate([[0.0], np.sort(rng.uniform(0.0, 1.0, nlev - 1)), [1.0]])
    grid = grid_from_conf(conf)
    gph = rng.uniform(0.0, 3e4, grid.shape).astype(np.float32)
    sig = {"ak": ak, "bk": bk}
    post = {"post_conf": {
        "activate": True,
        "tracer_fixer": {"activate": True, "tracer_vars": ["Q"], "tracer_thres": 0.0},
        "global_mass_fixer": {"activate": True, **sig},
        "global_water_fixer": {"activate": True, **sig},
        "global_energy_fixer": {"activate": True, "surface_geopotential": gph,
                                "toa_down_solar_input_var": "tsi",
                                "surf_net_solar_var": "surface_net_solar_radiation",
                                "surf_net_lw_var": "surface_net_thermal_radiation", **sig}}}
    blocks = build_postblocks(post, schema, grid, normalizer)
    return normalizer, blocks, HybridSigmaPhysics(grid, ak, bk, midpoint=True), torch.as_tensor(gph)


def physical_state(torch, normalizer, shape, idx, gen, device):
    """A seeded state in physical units: N(0, 0.5) in normalized space, for
    the channels `idx` of the Normalizer's input statistics."""
    z = torch.randn(shape, generator=gen, device=device) * 0.5
    return z * normalizer.input_std.to(device)[idx] + normalizer.input_mean.to(device)[idx]


class Recorder:
    """A postblock that keeps each step's prediction (in physical units,
    after the fixers) and the input the fixers were given."""

    def __init__(self):
        self.steps = []

    def __call__(self, y_pred, x):
        self.steps.append((y_pred, x))
        return y_pred


def budgets(torch, schema, core, gph, y, x) -> dict:
    """Each fixer's budget on one step, in f64 on the card, as
    tests/test_conservation.py reads them: the relative change of global
    dry-air mass from the input state; the water budget's residual over
    sum |precipitation flux|; the energy budget's over the net flux term;
    and the least Q."""
    from credit_torch.physics.constants import RHO_WATER

    def v(t, name, target=True):
        out = _var(schema, t, name, target).double()
        return out if target else out[:, -1:]

    q1, sp1, t1, u1, v1 = (v(y, n) for n in ("Q", "SP", "T", "U", "V"))
    q0, sp0, t0, u0, v0 = (v(x, n, False) for n in ("Q", "SP", "T", "U", "V"))
    m0, m1 = core.total_dry_air_mass(q0, sp0), core.total_dry_air_mass(q1, sp1)
    p = v(y, "total_precipitation") * RHO_WATER / LEAD_SECONDS
    e = v(y, "evaporation") * RHO_WATER / LEAD_SECONDS
    dtwc = (core.total_column_water(q1, sp1) - core.total_column_water(q0, sp0)) / LEAD_SECONDS
    gph = gph.double()
    e0 = core.weighted_sum(core.total_energy(t0, q0, u0, v0, sp0, gph))
    e1 = core.weighted_sum(core.total_energy(t1, q1, u1, v1, sp1, gph))
    r_t = core.weighted_sum(v(x, "tsi", False) - v(y, "top_net_solar_radiation")
                            - v(y, "top_net_thermal_radiation"))
    f_s = core.weighted_sum(v(y, "surface_net_solar_radiation")
                            + v(y, "surface_net_thermal_radiation")
                            + v(y, "surface_sensible_heat_flux") + v(y, "surface_latent_heat_flux"))
    rhs = LEAD_SECONDS * (r_t - f_s)
    return {"mass": ((m1 - m0).abs() / m0.abs()).max().item(),
            "water": (core.weighted_sum(dtwc + p + e).abs()
                      / core.weighted_sum(p.abs())).max().item(),
            "energy": ((e1 - e0 - rhs).abs() / rhs.abs()).max().item(),
            "q_min": q1.min().item()}


def ensemble_noise(torch, model, x, generator) -> dict:
    """A noise dict for `model` (a crossformer-ensemble) on input x, drawn
    from `generator` on the CPU: the latent and each noise layer's pixels
    at the shape its feature takes (read in one eval-mode forward, which
    leaves the spectral-norm state as it was)."""
    from credit_torch.models.sdl import DECODER_NOISE, ENCODER_NOISE

    shapes, hooks = {}, []
    for name in ENCODER_NOISE + DECODER_NOISE:
        hooks.append(getattr(model, name).register_forward_pre_hook(
            lambda mod, args, name=name: shapes.__setitem__(name, args[0].shape)))
    model.eval()
    with torch.no_grad():
        model(x, generator=torch.Generator().manual_seed(0))
    for h in hooks:
        h.remove()
    noise = {"latent": torch.randn((x.shape[0], model.noise_latent_dim), generator=generator)}
    noise.update({k: torch.randn(v, generator=generator) for k, v in shapes.items()})
    return noise


def tiny_ensemble(torch) -> None:
    """The tiny CrossFormer as crossformer-ensemble (f32, seeded weights
    with spectral-norm state) at TINY_MEMBERS members, on the card against
    the CPU with the same latent and pixel noise (drawn on the CPU, replayed
    on both): every member's forward and one make_train_step under the
    almost-fair CRPS, its loss and gradient norm, within 1e-4 relative.
    (The CRPS's gradient is piecewise constant in the prediction: a member
    pair within rounding of a kink on one device and not on the other
    would turn one sign, ~1e-3 of the norm, tests/
    test_torch_port_ensemble_fit.py; these seeded inputs have none.)"""
    import functools

    from credit_torch.convert_jax import init_train
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.losses import WeightedLoss
    from credit_torch.trainers.scheduler import constant
    from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step

    conf = {"model": {**TINY, "type": "crossformer-ensemble"}, "data": TINY_DATA}
    schema = ChannelSchema.from_config(conf)
    g = torch.Generator().manual_seed(6)
    x = torch.randn((1, 1, 32, 64, schema.n_input), generator=g)
    y = torch.randn((1, 1, 32, 64, schema.n_target), generator=g) * 0.5
    xe = torch.repeat_interleave(x, TINY_MEMBERS, dim=0)
    models = {dev: init_train(conf, torch.Generator().manual_seed(7), device=dev)
              for dev in ("cpu", "cuda")}
    noise = ensemble_noise(torch, models["cpu"], xe, g)
    outs, metrics = {}, {}
    for dev, model in models.items():
        nz = {k: v.to(dev) for k, v in noise.items()}
        with torch.no_grad():
            outs[dev] = model.eval()(xe.to(dev), noise=nz).cpu()
        # the train step's draws replaced by the same noise on both devices
        model.forward = functools.partial(type(model).forward, model, noise=nz)
        opt = make_optimizer({"trainer": {"grad_max_norm": 1.0, "weight_decay": 0.01}},
                             constant(1e-3))
        step = make_train_step(model, WeightedLoss(base="almost-fair-crps"), opt, schema,
                               ensemble_size=TINY_MEMBERS, device=dev)
        _, metrics[dev] = step(TrainState.create(model, opt, ema=True), {"x": x, "y": y})
        del model.forward
    ref = outs["cpu"]
    err = ((outs["cuda"] - ref).abs().max() / ref.abs().max()).item()
    spread = (ref[0] - ref[1]).abs().max().item()
    lerr, gerr = (abs(float(metrics["cuda"][k]) - float(metrics["cpu"][k]))
                  / abs(float(metrics["cpu"][k])) for k in ("loss", "grad_norm"))
    log(f"  tiny crossformer-ensemble, {TINY_MEMBERS} members, f32 card vs CPU, same noise: "
        f"forward rel err {err:.3e} limit 1e-4 (members apart by {spread:.3e}); CRPS train step "
        f"loss rel err {lerr:.3e}, grad norm rel err {gerr:.3e}, limit 1e-4")
    if not (err <= 1e-4 and spread > 0 and lerr <= 1e-4 and gerr <= 1e-4):
        raise AssertionError("the tiny ensemble on the card disagrees with the CPU")


def _zoo_inputs(torch, name: str, dtype=None):
    """Phase 3's seeded inputs of a zoo model on the CPU: the state, then its
    extra inputs (diffusion: the noisy target and t in [0, 1))."""
    _, xshape, extra = TINY_ZOO[name]
    g = torch.Generator().manual_seed(2)
    arrs = [torch.randn(xshape, generator=g)]
    arrs += [torch.rand(s, generator=g) if len(s) == 1 else torch.randn(s, generator=g)
             for s in extra]
    return arrs


def _zoo_call(model, arrs):
    if len(arrs) == 3 and arrs[2].dim() == 1:  # diffusion: (x, y_noisy, t_frac)
        return model(arrs[0], y_noisy=arrs[1], t_frac=arrs[2])
    return model(*arrs)


def tiny_zoo(torch) -> None:
    """Every model type this port adds beyond the CrossFormer, FuXi and the
    ensemble (TINY_ZOO), tiny, on the card against the same model on the CPU
    (plain versions, which the CPU tests hold against the JAX package): the
    f32 forward on seeded folded weights within 1e-4 of max |CPU|, the bf16
    forward on the card against the f32 CPU within 5e-2, and one train-mode
    forward and backward (spectral-norm state, one power iteration) through
    an MSE loss: the loss within 1e-4 relative and each parameter's gradient
    within 1e-4 of its largest (at least 1e-2 of the model's), as phase 3's
    CrossFormer. The forward's launches are printed."""
    from credit_torch.convert_jax import init_folded, init_train

    for name, (mconf, _, _) in TINY_ZOO.items():
        conf = {"model": mconf}
        arrs = _zoo_inputs(torch, name)
        cuda = [a.cuda() for a in arrs]
        cpu = init_folded(conf, torch.Generator().manual_seed(1), device="cpu")
        gpu = init_folded(conf, torch.Generator().manual_seed(1), device="cuda")
        # the same draws with bf16 compute, the weights cast once
        gpub = init_folded({"model": {**mconf, "compute_dtype": "bfloat16"}},
                           torch.Generator().manual_seed(1), device="cuda").to(torch.bfloat16)
        _zero_counts()
        with torch.no_grad():
            ref = _zoo_call(cpu, arrs)
            out = _zoo_call(gpu, cuda).cpu()
            torch.cuda.synchronize()
            counts = {k: v for k, v in _read_counts().items() if v}
            # the diffusion time stays f32: bf16 would move 1000 t by up to 2
            outb = _zoo_call(gpub, [a.to(torch.bfloat16) if a.dim() > 1 else a
                                    for a in cuda]).float().cpu()
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item() / scale
        errb = (outb - ref).abs().max().item() / scale
        target = torch.randn(ref.shape, generator=torch.Generator().manual_seed(3)) * 0.5
        losses, grads = {}, {}
        for dev in ("cpu", "cuda"):
            model = init_train(conf, torch.Generator().manual_seed(4), device=dev).train()
            loss = torch.mean((_zoo_call(model, [a.to(dev) for a in arrs]) - target.to(dev)) ** 2)
            loss.backward()
            losses[dev] = loss.item()
            grads[dev] = {k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                          for k, p in model.named_parameters()}
        lerr = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        gmax = max(v.abs().max().item() for v in grads["cpu"].values())
        gerr = max((grads["cuda"][k] - v).abs().max().item()
                   / max(v.abs().max().item(), 1e-2 * gmax) for k, v in grads["cpu"].items())
        log(f"  {name}: out {tuple(out.shape)}; f32 forward card vs CPU rel err {err:.3e} "
            f"limit 1e-4; bf16 card vs f32 CPU {errb:.3e} limit 5e-2; train-mode loss "
            f"{lerr:.3e}, gradients, worst parameter {gerr:.3e}, limit 1e-4; forward launches "
            f"{counts}")
        if not (err <= 1e-4 and errb <= 5e-2 and lerr <= 1e-4 and gerr <= 1e-4):
            raise AssertionError(f"tiny {name} on the card disagrees with the CPU")


def expected_nextgen_per_step(conf: dict):
    """Kernel launches of one NextGen forward: the CrossFormer stages' FFs
    and attention; one VALID conv per cross-embed, four 3x3 convs per
    UpBlockPS (sub-pixel, sharp, two residual) and the head's sub-pixel
    conv. Column attention (plain PyTorch) and the bottleneck (GEMMs) launch
    none."""
    fwd = expected_per_step(conf)
    return {**fwd, "conv2d_valid": 4 + 3 * 4 + 1}


def expected_ps_per_step(conf: dict):
    """The sub-pixel CrossFormer's (camulator with upsample_with_ps): the
    embeds, three UpBlockPS of four 3x3 convs, the head's sub-pixel and
    refine convs and camulator's sharp conv."""
    return {**expected_per_step(conf), "conv2d_valid": 4 + 3 * 4 + 3}


def zoo_fit(torch, store_info, name: str, model: dict, extra: dict, want_train: dict,
            want_valid: dict, valid_per_batch: int = 1) -> tuple:
    """run_training of `model` on main path 7's store for one epoch of
    ZOO_TRAINER (2 steps, 1 validation batch); the log finite, the launches
    checked (valid_per_batch forwards a validation batch), the checkpoint
    read back into a fresh state bitwise (trainer.load_weights). Returns
    the counts and the run's step and validation ms."""
    from credit_torch.applications import prepare_training
    from credit_torch.trainers.trainer import Trainer

    store, stats, data, _ = store_info
    root = os.path.join(os.path.dirname(store), name)
    conf = {**fit_conf(model, data, store, stats, root, ZOO_TRAINER, *FIT_WINDOWS), **extra}
    conf["trainer"] = {**ZOO_TRAINER, **extra.get("trainer", {})}
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.time()
    trainer, state, start, seed = prepare_training(conf)
    nparam = sum(p.numel() for p in trainer.model.parameters())
    log(f"  {name}: {type(trainer).__name__}, {nparam} parameters; set-up {time.time() - t0:.1f} s")
    state = trainer.fit(state, seed=seed, start_epoch=start)
    torch.cuda.synchronize()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  {name} run_training 1 epoch: {time.time() - t0:.1f} s end to end, peak memory "
        f"{peak} bytes ({peak / 2**30:.2f} GiB), launches {counts}")
    fit_times(trainer)
    rows = read_log(root)
    cells = [float(c) for r in rows[1:] for c in r[1:]]
    log(f"  training_log.csv: {len(rows) - 1} row, columns {rows[0][:6]}..., (train, valid) "
        f"loss {[(float(r[1]), float(r[2])) for r in rows[1:]]}")
    if len(rows) != 2 or not all(math.isfinite(v) for v in cells) or state.step != 2:
        raise AssertionError(f"the {name} fit failed its checks")
    _check_counts(counts, {k: 2 * want_train.get(k, 0) + valid_per_batch * want_valid.get(k, 0)
                           for k in counts}, 1)
    e = trainer.epoch_timings[0]
    saved = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    ema = {k: v.cpu().clone() for k, v in state.ema_params.items()}
    del state, trainer
    torch.cuda.empty_cache()
    resume = {**conf, "trainer": {**conf["trainer"], "load_weights": True}}
    trainer, state, start, _ = prepare_training(resume)
    same = (all(torch.equal(v.cpu(), saved[k]) for k, v in state.model.state_dict().items())
            and all(torch.equal(v.cpu(), ema[k]) for k, v in state.ema_params.items()))
    log(f"  checkpoint read back: step {state.step}, epoch {start}; parameters, u/v and EMA "
        f"bitwise equal to the trained state: {same}")
    if not same or state.step != 2 or start != 1 or not os.path.exists(
            os.path.join(root, "checkpoint", Trainer.CHECKPOINT_FILE)):
        raise AssertionError(f"the {name} checkpoint did not read back")
    del state, trainer
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, e["train_ms"], e["valid_ms"]


def nextgen_path(torch, store_info, runs: dict) -> None:
    """Main path 12: NextGen WXFormer at CONF_025_TRAIN width (CONF_NEXTGEN):
    run_training of one epoch of 2 steps and 1 validation batch on main path
    7's store with its checkpoint read back, then a ZOO_ROLLOUT_STEPS-step
    bf16 forecast through make_scan_rollout; beside it camulator with the
    sub-pixel decoder at the same widths, one training step and a
    ZOO_ROLLOUT_STEPS-step bf16 rollout. Launches per step checked and
    printed for both."""
    data = store_info[2]
    fwd_ng = expected_nextgen_per_step(CONF_NEXTGEN)
    train_ng = expected_train_per_step(fwd_ng, True)
    runs["fit_nextgen"], steps, valid = zoo_fit(torch, store_info, "nextgen", CONF_NEXTGEN, {},
                                                train_ng, fwd_ng)
    log(f"  NextGen launches a training step {train_ng}, a forward {fwd_ng}")
    runs["rollout_nextgen"] = rollout_path(torch, "NextGen", CONF_NEXTGEN, data, fwd_ng,
                                           steps=ZOO_ROLLOUT_STEPS, repeats=0)
    torch.cuda.empty_cache()
    fwd_ps = expected_ps_per_step(CONF_CAMULATOR_PS)
    train_ps = expected_train_per_step(fwd_ps, False)
    log(f"  camulator with upsample_with_ps: launches a training step {train_ps}, a forward "
        f"{fwd_ps}")
    runs["train_camulator_ps"] = train_path(torch, "camulator-PS", CONF_CAMULATOR_PS, data,
                                            train_ps, steps=1)
    torch.cuda.empty_cache()
    runs["rollout_camulator_ps"] = rollout_path(torch, "camulator-PS", CONF_CAMULATOR_PS, data,
                                                fwd_ps, steps=ZOO_ROLLOUT_STEPS, repeats=0)


def diffusion_path(torch, store_info, runs: dict) -> None:
    """Main path 13: the era5-diffusion trainer with crossformer-diffusion at
    CONF_025_TRAIN width (CONF_DIFFUSION), one epoch of 2 steps and 1
    validation batch sampled by DDIM in DIFFUSION's 20 steps from the EMA
    weights, on main path 7's store; the checkpoint read back. A training
    step is one denoising forward and backward (the time-FiLM makes the
    stage-0 embed's input need its gradient); a validation batch 20
    forwards."""
    fwd = expected_per_step(CONF_DIFFUSION)
    train = expected_train_per_step(fwd, True)
    steps = DIFFUSION["sampling_timesteps"]
    log(f"  launches a training step {train}, a DDIM step {fwd}")
    runs["fit_diffusion"], train_ms, valid_ms = zoo_fit(
        torch, store_info, "diffusion", CONF_DIFFUSION,
        {"diffusion": DIFFUSION, "trainer": {"type": "era5-diffusion"}}, train, fwd,
        valid_per_batch=steps)
    log(f"  diffusion: ms per train step {[round(v, 1) for v in train_ms]}, ms per validation "
        f"batch ({steps} DDIM steps) {[round(v, 1) for v in valid_ms]}, "
        f"{valid_ms[0] / steps:.1f} ms a DDIM step")


class TimedDraws:
    """While open, every draw through the ensemble's seam
    (`ensemble.noise.normal`: a randn on the generator's device, the host's
    for the port's callers, then the copy to the state's device) timed on
    the host clock to the card's synchronization: `ms` holds each draw's."""

    def __init__(self, torch):
        self.torch, self.ms = torch, []

    def __enter__(self):
        from credit_torch.ensemble import noise

        self.normal = normal = noise.normal

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = normal(*args, **kw)
            self.torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        noise.normal = timed
        return self

    def __exit__(self, *exc):
        from credit_torch.ensemble import noise

        noise.normal = self.normal

    def __str__(self):
        return (f"{len(self.ms)} draws (host randn and copy) of "
                f"{[round(m, 1) for m in self.ms]} ms")


def ensemble_rollout_025(torch, conf: dict, pert: dict, want: dict, forwards: int) -> tuple:
    """run_rollout of `conf` with the predict section's ensemble `pert`,
    timed: each member's engine run with its writes (set-up the rest),
    the peak memory, the launches (`forwards` forwards of `want`). Returns
    (counts, written paths, the bred members' initial states or None)."""
    from credit_torch import rollout
    from credit_torch.applications import run_rollout
    from credit_torch.ensemble import bred_vector

    runs, bred = [], []
    engine_run, generate = rollout.RolloutEngine.run, bred_vector.generate_bred_vectors

    def timed_run(self, *args, **kw):
        t0 = time.perf_counter()
        res = engine_run(self, *args, **kw)
        runs.append((time.perf_counter() - t0) * 1e3)
        return res

    def kept(*args, **kw):
        members = generate(*args, **kw)
        bred.append((args[1].clone(), [m.clone() for m in members]))
        return members

    run = {**conf, "predict": {**conf["predict"], **pert}}
    rollout.RolloutEngine.run, bred_vector.generate_bred_vectors = timed_run, kept
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    try:
        with TimedDraws(torch) as draws:
            t0 = time.time()
            paths = run_rollout(run, use_ema=True)
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
    finally:
        rollout.RolloutEngine.run, bred_vector.generate_bred_vectors = engine_run, generate
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = run["predict"]["forecast_steps"]
    log(f"  {pert['perturbation']} ensemble of {pert['ensemble_size']} (control + "
        f"{pert['ensemble_size'] - 1}), {steps} steps: {wall:.0f} ms end to end, set-up "
        f"(data, trainer, checkpoint, fold{', breeding' if bred else ''}) "
        f"{wall - sum(runs):.0f} ms, of which {draws}; ms/step with the writes by member "
        f"{[round(r / steps, 1) for r in runs]}; peak {peak} bytes ({peak / 2**30:.2f} GiB); "
        f"launches {counts}")
    _check_counts(counts, want, forwards)
    return counts, paths, bred[0] if bred else None


def icopt_grad_routes(torch, model, x0, target) -> tuple:
    """ic-opt's gradient at x0 of one step's MSE against `target`, the
    model frozen in eval mode, through the kernels, with every conv on its
    plain version (`cuda_conv.conv2d_valid` pointed at `conv2d_valid_plain`:
    the forward and, on the flipped kernel, the input gradient), and with
    the plain version summing its taps in reverse (another rounding of the
    same sums); returns for the kernels and for the reversed sums (relative
    L2 distance from the plain gradient, largest |difference| over largest
    |plain|)."""
    from credit_torch.ops import cuda_conv

    def reversed_taps(x, kernel):
        kh, kw = kernel.shape[:2]
        ho, wo = x.shape[1] - kh + 1, x.shape[2] - kw + 1
        xf, kf = x.float(), kernel.float()
        out = torch.zeros((x.shape[0], ho, wo, kernel.shape[3]), dtype=torch.float32,
                          device=x.device)
        for di in reversed(range(kh)):
            for dj in reversed(range(kw)):
                out += xf[:, di:di + ho, dj:dj + wo, :] @ kf[di, dj]
        return out.to(x.dtype)

    def grad():
        x = x0.clone().requires_grad_(True)
        torch.mean((model(x) - target) ** 2).backward()
        return x.grad.double()

    params = [p for p in model.parameters() if p.requires_grad]
    kernel_conv, training = cuda_conv.conv2d_valid, model.training
    try:
        model.eval()
        for p in params:
            p.requires_grad_(False)
        g_kernel = grad()
        cuda_conv.conv2d_valid = cuda_conv.conv2d_valid_plain
        g_plain = grad()
        cuda_conv.conv2d_valid = reversed_taps
        g_reversed = grad()
    finally:
        cuda_conv.conv2d_valid = kernel_conv
        for p in params:
            p.requires_grad_(True)
        model.train(training)
    norm, top = torch.linalg.vector_norm(g_plain), g_plain.abs().max()
    return tuple((float(torch.linalg.vector_norm(g - g_plain) / norm),
                  float((g - g_plain).abs().max() / top)) for g in (g_kernel, g_reversed))


def ensemble_path(torch, store_info, runs: dict) -> None:
    """Main path 14, ensemble forecasts and their verification at CONF_025
    width, from main path 7's store and checkpoint: (a) run_rollout with
    ENS_GAUSSIAN then ENS_BRED (one init time of ENS_STEPS); (b)
    run_rollout_metrics of ENS_MEMBERS members, gaussian and bred; (c)
    run_ensemble_eval over (a)'s gaussian tree, one lead; (d) ic-opt on the
    folded weights; (e) ptype on (a)'s control prediction, card against
    CPU; (f) the SDL wrapper on CONF_025_ENS. Removes (a)'s trees."""
    import numpy as np

    from credit_torch import metrics
    from credit_torch.applications import experiment
    from credit_torch.applications.ensemble_eval import flat_from_netcdf, run_ensemble_eval
    from credit_torch.applications.rollout_metrics import run_rollout_metrics
    from credit_torch.convert_jax import init_folded
    from credit_torch.ensemble.sdl_wrapper import SDLInferenceWrapper
    from credit_torch.ops import sht as sht_mod
    from credit_torch.ptype import PTYPES, PTypeClassifier
    from credit_torch.trainers.ic_optimization import optimize_initial_condition
    from credit_torch.trainers.trainer import Trainer
    from credit_torch.utils.ncio import open_dataset

    store, stats, data, run = store_info
    root = os.path.dirname(store)
    conf = fit_conf(CONF_025_TRAIN, data, store, stats, run, FIT_TRAINER, NC_WINDOW,
                    FIT_WINDOWS[1])
    conf["predict"] = {"forecasts": {"start_year": 1979, "start_month": 1, "start_day": 1,
                                     "start_hours": [0], "duration": 1},
                       "forecast_steps": ENS_STEPS}
    fwd = expected_per_step(CONF_025_TRAIN)
    label = "1979-01-01T00Z"

    log("  (a) run_rollout with predict.ensemble_size > 1")
    gauss = os.path.join(root, "ens_gaussian")
    runs["ens_rollout"], paths, _ = ensemble_rollout_025(
        torch, conf, {**ENS_GAUSSIAN, "save_forecast": gauss}, fwd,
        ENS_GAUSSIAN["ensemble_size"] * ENS_STEPS)
    bred_dir = os.path.join(root, "ens_bred")
    n_bred = ENS_BRED["ensemble_size"] - 1
    runs["ens_rollout_bred"], bred_paths, (x_ic, members) = ensemble_rollout_025(
        torch, conf, {**ENS_BRED, "save_forecast": bred_dir}, fwd,
        ENS_BRED["ensemble_size"] * ENS_STEPS + (n_bred + 1) // 2 * 2 * ENS_BRED["bred_cycles"])
    mirror = ((members[0] - x_ic) + (members[1] - x_ic)).abs().max().item()
    # e01 - IC and e02 - IC cancel but for their rounding at the IC's magnitude
    mirror_limit = 4 * 2.0**-23 * x_ic.abs().max().item()
    bv = (members[0] - x_ic).double()
    rms = torch.sqrt((bv ** 2).mean()).item()
    dirs = {tree: sorted(os.listdir(tree)) for tree in (gauss, bred_dir)}
    want_dirs = {gauss: [label] + [f"{label}_e{m:02d}" for m in range(1, 4)],
                 bred_dir: [label] + [f"{label}_e{m:02d}" for m in range(1, 3)]}
    names_ok = all(dirs[t] == want_dirs[t] and sorted(
        os.path.relpath(p, t) for p in ps) == sorted(
        os.path.join(d, f"pred_{d}_{6 * (s + 1):03d}.nc") for d in want_dirs[t]
        for s in range(ENS_STEPS)) for t, ps in ((gauss, paths), (bred_dir, bred_paths)))
    apart = {}
    for tree in (gauss, bred_dir):
        first = open_dataset(os.path.join(tree, label, f"pred_{label}_006.nc"))
        for d in want_dirs[tree][1:]:
            other = open_dataset(os.path.join(tree, d, f"pred_{d}_006.nc"))
            apart[f"{os.path.basename(tree)}/{d[len(label):]}"] = max(
                float(np.abs(np.asarray(other[k].values, np.float64)
                             - np.asarray(first[k].values)).max()) for k in first.keys())
    log(f"  member directories {dirs[gauss]} and {dirs[bred_dir]}, file names as expected "
        f"{names_ok}; first-step files apart from the control's by (largest |difference|) "
        f"{ {k: f'{v:.3e}' for k, v in apart.items()} }; the bred pair at the IC: "
        f"|(e01 - IC) + (e02 - IC)| <= {mirror:.3e} (limit {mirror_limit:.3e}), RMS of e01 - IC "
        f"{rms:.6f} (amplitude "
        f"{ENS_BRED['perturbation_std']})")
    if not (names_ok and all(v > 0 for v in apart.values()) and mirror <= mirror_limit
            and abs(rms - ENS_BRED["perturbation_std"]) <= 1e-3 * ENS_BRED["perturbation_std"]):
        raise AssertionError("the CONF_025 ensemble rollout failed its checks")
    shutil.rmtree(bred_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    log(f"  (b) run_rollout_metrics, {ENS_MEMBERS} members, {ENS_STEPS} steps")
    from credit_torch import rollout
    engine_run = rollout.RolloutEngine.run
    for pert, key in (("gaussian", "ens_metrics"), ("bred", "ens_metrics_bred")):
        member_ms = []

        def timed_run(self, *args, **kw):
            t0 = time.perf_counter()
            res = engine_run(self, *args, **kw)
            member_ms.append((time.perf_counter() - t0) * 1e3)
            return res

        mconf = {**conf, "predict": {"forecast_steps": ENS_STEPS, "ensemble": {
            "amplitude": ENS_BRED["perturbation_std"], "size": ENS_MEMBERS,
            "perturbation": pert}}}
        rollout.RolloutEngine.run = timed_run
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        try:
            with TimedDraws(torch) as draws:
                t0 = time.time()
                rows = run_rollout_metrics(mconf)
                wall = (time.time() - t0) * 1e3
        finally:
            rollout.RolloutEngine.run = engine_run
        runs[key] = counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        shown = ("step", "crps", "rmse", "spread", "spread_skill_ratio")
        log(f"  {pert}: {wall:.0f} ms end to end, {draws}; ms per member-step (run, host copies "
            f"included) {[round(m / ENS_STEPS, 1) for m in member_ms]}; peak {peak / 2**30:.2f} "
            f"GiB; rows {[{k: round(r[k], 5) for k in shown} for r in rows]}; "
            f"launches {counts}")
        cells = [v for r in rows for v in r.values()]
        if not (len(rows) == ENS_STEPS and all(math.isfinite(v) for v in cells)
                and all(r["spread"] > 0 for r in rows)):
            raise AssertionError(f"the CONF_025 {pert} rollout_metrics failed its checks")
        breeding = (ENS_MEMBERS + 1) // 2 * 2 * 3 if pert == "bred" else 0
        _check_counts(counts, fwd, ENS_MEMBERS * ENS_STEPS + breeding)
        torch.cuda.empty_cache()

    log("  (c) run_ensemble_eval over (a)'s gaussian tree, one lead")
    lead_root = os.path.join(root, "ens_eval")
    for d in os.listdir(gauss):
        os.makedirs(os.path.join(lead_root, d))
        shutil.copy(os.path.join(gauss, d, f"pred_{d}_006.nc"), os.path.join(lead_root, d))
    spectra, spectra_fn = [], metrics.divergent_rotational_spectra
    builds, real_sht = [], sht_mod.SHT

    def timed_spectra(*args, **kw):
        t0 = time.perf_counter()
        res = spectra_fn(*args, **kw)
        torch.cuda.synchronize()
        spectra.append(time.perf_counter() - t0)
        return res

    def timed_sht(*args, **kw):
        t0 = time.perf_counter()
        sht = real_sht(*args, **kw)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
        return sht

    metrics.divergent_rotational_spectra, sht_mod.SHT = timed_spectra, timed_sht
    try:
        t0 = time.time()
        rows = run_ensemble_eval(conf, lead_root, out_path=os.path.join(root, "ens_eval.json"))
        wall = time.time() - t0
    finally:
        metrics.divergent_rotational_spectra, sht_mod.SHT = spectra_fn, real_sht
    row = rows[0]
    nums = [v for r in rows for x in r.values() if not isinstance(x, str)
            for v in (x if isinstance(x, list) else [x])]
    log(f"  {len(rows)} row(s), {len(row)} keys, {row['n_members']} members: spread "
        f"{row.get('spread', math.nan):.5f}, rmse {row.get('rmse', math.nan):.5f}, "
        f"spread/skill {row.get('spread_skill_ratio', math.nan):.5f}; {wall:.1f} s a lead, of "
        f"which the SHT's table builds {sum(builds):.1f} s in {len(builds)} (share "
        f"{sum(builds) / wall:.3f}) and divergent_rotational_spectra {sum(spectra):.2f} s in "
        f"{len(spectra)} calls on the built tables")
    if not (len(rows) == 1 and row["n_members"] == 4 and row.get("spread", 0) > 0
            and "rmse" in row and all(math.isfinite(v) for v in nums) and len(spectra) == 13
            and len(builds) == 1):
        raise AssertionError("the CONF_025 ensemble_eval failed its checks")
    shutil.rmtree(lead_root, ignore_errors=True)

    log(f"  (d) ic-opt on the folded CONF_025 weights (bf16 compute), {ICOPT_STEPS} steps, "
        f"{ICOPT_ITERS} iterations")
    exp = experiment.build_data(conf)
    norm, schema, ds = exp["normalizer"], exp["schema"], exp["dataset"]
    saved = torch.load(os.path.join(run, "checkpoint", Trainer.CHECKPOINT_FILE),
                       map_location="cuda", weights_only=True)
    model = experiment._inference_model(conf, {**saved["model"], **saved["ema_params"]},
                                        torch.device("cuda"))
    del saved
    t0i = ds.index_of("1979-01-01T00:00:00")
    x0 = norm.normalize_input(torch.as_tensor(ds.input_at(t0i)[None]).cuda())
    targets = norm.normalize_target(torch.as_tensor(np.stack(
        [ds.target_at(t0i + 1 + s)[0] for s in range(ICOPT_STEPS)])[None]).cuda())
    forcing = norm.normalize_forcing(torch.as_tensor(np.stack(
        [ds.forcing_at(t0i + s)[0] for s in range(ICOPT_STEPS)])[None]).cuda(), schema)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.time()
    x_opt, losses = optimize_initial_condition(model, schema, x0, targets, forcing,
                                               n_steps=ICOPT_STEPS, iterations=ICOPT_ITERS,
                                               learning_rate=1e-2)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    runs["icopt"] = counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    moved = (x_opt - x0).abs().max().item()
    want_it = {**expected_train_per_step(fwd, True), "conv2d_wgrad": 0}
    log(f"  losses {[round(v, 6) for v in losses]}; x0 moved by up to {moved:.4f}; "
        f"{wall / ICOPT_ITERS:.0f} ms an iteration (the first's set-up included); peak "
        f"{peak} bytes ({peak / 2**30:.2f} GiB); launches {counts}, expected per step {want_it}")
    if not (losses[-1] < losses[0] and all(math.isfinite(v) for v in losses) and moved > 0):
        raise AssertionError("ic-opt at CONF_025 failed its checks")
    _check_counts(counts, want_it, ICOPT_ITERS * ICOPT_STEPS)
    (rel, top), (floor, _) = icopt_grad_routes(torch, model, x0, targets[:, :1])
    log(f"  the gradient at x0 (one step) through the kernels against every conv on its plain "
        f"version: relative L2 distance {rel:.3e}, largest |difference| over largest |plain| "
        f"{top:.3e}; the plain version summing its taps in reverse: {floor:.3e} (limit "
        f"{ICOPT_GRAD_FACTOR:g} x that)")
    if not rel <= ICOPT_GRAD_FACTOR * floor:
        raise AssertionError("ic-opt's gradient at x0 disagrees with the plain convs'")
    del model, x_opt, x0, targets, forcing
    torch.cuda.empty_cache()

    log("  (e) ptype on (a)'s control prediction (T and Q at 13 levels, SP), 721x1440, seeded "
        "weights, card against CPU")
    ds0 = open_dataset(os.path.join(gauss, label, f"pred_{label}_006.nc"))
    y = torch.as_tensor(flat_from_netcdf(ds0, schema))[None, None]
    fields, ms = {}, {}
    for dev in ("cpu", "cuda"):
        clf = PTypeClassifier(device=dev)
        clf.init(torch.Generator().manual_seed(3), 2 * len(FIT_LEVELS))
        clf.classify_state(y, schema, exp["grid"])  # warm-up
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fields[dev] = clf.classify_state(y, schema, exp["grid"])
        ms[dev] = (time.perf_counter() - t0) * 1e3
    card, cpu = fields["cuda"], fields["cpu"]
    err = max(_rel(torch.from_numpy(card[k]), torch.from_numpy(v)) for k, v in cpu.items()
              if not k.startswith("ML_c"))
    probs = np.stack([card[f"ML_{p}"] for p in PTYPES], -1)
    onehot = np.stack([card[f"ML_c{p}"] for p in PTYPES], -1)
    top2 = np.sort(probs, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5
    winners_cpu = np.stack([cpu[f"ML_c{p}"] for p in PTYPES], -1)
    agree = bool((onehot == winners_cpu).all(-1)[clear].all())
    sums = float(np.abs(probs.sum(-1) - 1).max())
    log(f"  {len(card)} fields of shape {card['ML_rain'].shape}: card {ms['cuda']:.1f} ms "
        f"(host copies included), CPU {ms['cpu']:.0f} ms; card vs CPU rel err {err:.3e} limit "
        f"{PTYPE_TOL:g}; probabilities sum to 1 within {sums:.2e}; winners one-hot "
        f"{bool(((onehot == 0) | (onehot == 1)).all() and (onehot.sum(-1) == 1).all())}, equal "
        f"to the CPU's where the top two differ by > 1e-5 ({int(clear.sum())} of "
        f"{clear.size} points) {agree}")
    if not (err <= PTYPE_TOL and sums <= 1e-5 and agree and (onehot.sum(-1) == 1).all()):
        raise AssertionError("ptype at 721x1440 failed its checks")
    shutil.rmtree(gauss, ignore_errors=True)

    log("  (f) the SDL wrapper on CONF_025_ENS (phase 11's crossformer-ensemble), folded, bf16")
    sconf = {"model": CONF_025_ENS, "data": data}
    wrapper = SDLInferenceWrapper(init_folded(sconf, torch.Generator().manual_seed(5)))
    xs = torch.randn((1, 1, CONF_025["image_height"], CONF_025["image_width"], schema.n_input),
                     generator=torch.Generator(device="cuda").manual_seed(6), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    gen = torch.Generator(device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y1, lat1 = wrapper.forward(xs, generator=gen.manual_seed(7), capture=True)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    replay = torch.equal(wrapper.forward(xs, latents=lat1), y1)
    y2, lat2 = wrapper.forward(xs, generator=gen.manual_seed(8), capture=True)
    apart = (y1 - y2).abs().max().item()
    wrapper.store_latents("a", lat1)
    wrapper.store_latents("b", lat2)
    interp0 = torch.equal(wrapper.forward(xs, latents=wrapper.interpolate_latents("a", "b", 0.0)),
                          y1)
    wrapper.set_noise_factors(0.0)
    zero = torch.equal(wrapper.forward(xs, latents=lat1), wrapper.forward(xs, latents=lat2))
    wrapper.reset_to_original()
    torch.cuda.synchronize()
    runs["sdl_025"] = counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  a capture {fwd_ms:.1f} ms; replay bitwise {replay}; two draws apart by {apart:.3e}; "
        f"with every factor 0 two draws give the same output {zero}; interpolation at t = 0 "
        f"equals the first capture {interp0}; peak {peak / 2**30:.2f} GiB; launches {counts}")
    if not (replay and zero and interp0 and apart > 0):
        raise AssertionError("the SDL wrapper at CONF_025 failed its checks")
    _check_counts(counts, fwd, 6)
    del wrapper, xs, y1, y2, lat1, lat2
    torch.cuda.empty_cache()


def tiny_post_rollout(torch) -> None:
    """A 2-step RolloutEngine.run of a tiny CrossFormer with the seeded
    Normalizer and the four fixers (one Normalizer and one pipeline for
    both devices), on the card (kernels) against the CPU (plain versions),
    f32: every emitted prediction within 1e-3 of its
    channel's max |CPU| (the fixers' global ratios carry the forward's
    summation-order differences into every cell)."""
    import numpy as np

    from credit_torch.convert_jax import init_folded
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.rollout import RolloutEngine

    conf = {"model": TINY_POST, "data": TINY_POST_DATA}
    schema = ChannelSchema.from_config(conf)
    normalizer, blocks, _, _ = forecast_setup(conf, seed=3)
    x0 = physical_state(torch, normalizer, (1, 1, 32, 64, schema.n_input),
                        slice(None), torch.Generator().manual_seed(2), "cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        model = init_folded(conf, torch.Generator().manual_seed(1), device=dev)
        engine = RolloutEngine(model, schema, normalizer, postblocks=blocks, device=dev)
        outs[dev] = engine.run(x0, 2)
        engine.close()
    err = 0.0
    for out, ref in zip(outs["cuda"], outs["cpu"]):
        o, r = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
        err = max(err, float((np.abs(o - r).max(0) / np.maximum(np.abs(r).max(0), 1e-30)).max()))
    fin = all(np.isfinite(o).all() for o in outs["cuda"])
    log(f"  tiny 2-step RolloutEngine with Normalizer and 4 fixers, f32 card vs CPU: worst "
        f"channel rel err {err:.3e} limit 1e-3; finite {fin}")
    if not (fin and err <= 1e-3):
        raise AssertionError("tiny normalized rollout with fixers on the card disagrees with the CPU")


def post_path(torch, want: dict, times: dict, profile: bool = False) -> dict:
    """Main path 5: CONF_025_POST through RolloutEngine in physical units
    with the seeded Normalizer, the four fixers and a seeded forcing each
    step; a warm-up step, then POST_STEPS timed steps whose launches are
    counted and checked against `want` per step, and each step's budgets
    against POST_LIMITS; returns the counts."""
    from credit_torch.convert_jax import init_folded
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.rollout import RolloutEngine

    conf = {"model": CONF_025_TRAIN, "data": DATA_025_POST}
    schema = ChannelSchema.from_config(conf)
    h, w = CONF_025["image_height"], CONF_025["image_width"]
    t0 = time.time()
    model = init_folded(conf, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    model = model.to(torch.bfloat16)
    normalizer, blocks, core, gph = forecast_setup(conf, seed=0)
    core, gph = core.to("cuda"), gph.cuda()
    rec = Recorder()
    blocks = blocks[:-1] + [rec] + blocks[-1:]  # read the budgets before Renorm
    torch.cuda.synchronize()
    log(f"  CONF_025_POST: {schema.n_input} inputs, {schema.n_target} outputs, postblocks "
        f"{[type(b).__name__ for b in blocks]}; set-up {time.time() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    x0 = physical_state(torch, normalizer, (1, 1, h, w, schema.n_input), slice(None), g, "cuda")
    dyn = schema.dynamic_forcing_indices()
    forcing = [physical_state(torch, normalizer, (1, 1, h, w, len(dyn)), dyn, g, "cuda")
               for _ in range(POST_STEPS + 1)]
    engine = RolloutEngine(model, schema, normalizer, postblocks=blocks, device="cuda")
    t0 = time.time()
    engine.run(x0, 1, forcing_provider=lambda s: forcing[s], on_step=lambda s, y: None)
    torch.cuda.synchronize()
    log(f"  warm-up step: {(time.time() - t0) * 1e3:.1f} ms")
    rec.steps.clear()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    engine.run(x0, POST_STEPS, forcing_provider=lambda s: forcing[s], on_step=lambda s, y: None)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    ms = elapsed * 1e3 / POST_STEPS
    ref_ms = times.get("CONF_025")
    copy_ms = engine.copy_ms
    log(f"  CONF_025_POST RolloutEngine {POST_STEPS} steps: {ms:.1f} ms/step (phase 4's "
        f"make_scan_rollout: {ref_ms:.1f} ms/step; before the pinned copy ring: "
        f"{POST_PAGEABLE}), peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB; {base} allocated before it), launches {counts}")
    log(f"  each prediction's copy to pinned host memory on the side stream, ms: "
        f"{[round(v, 2) for v in copy_ms]} ({y_bytes(schema, h, w)} bytes each)")
    times["CONF_025_POST"] = ms
    _check_counts(counts, want, POST_STEPS)
    if len(rec.steps) != POST_STEPS:
        raise AssertionError(f"{len(rec.steps)} postblock passes, expected {POST_STEPS}")
    for s, (y, x) in enumerate(rec.steps):
        if y.shape != (1, 1, h, w, schema.n_target) or y.dtype != torch.float32:
            raise AssertionError((tuple(y.shape), y.dtype))
        fin = torch.isfinite(y).all().item()
        b = budgets(torch, schema, core, gph, y, x)
        ok = fin and b["q_min"] >= 0.0 and all(b[k] <= lim for k, lim in POST_LIMITS.items())
        log(f"  step {s}: finite {fin}; dry-air mass rel change {b['mass']:.3e} limit "
            f"{POST_LIMITS['mass']:g}; water budget residual {b['water']:.3e} limit "
            f"{POST_LIMITS['water']:g}; energy budget residual {b['energy']:.3e} limit "
            f"{POST_LIMITS['energy']:g}; min Q {b['q_min']:.3e} (>= 0){'' if ok else '  FAIL'}")
        # the fixers see the normalized input (as credit_tpu's RolloutEngine
        # hands it to them): the gap to the physical input state, not checked
        bp = budgets(torch, schema, core, gph, y, normalizer.denormalize_input(x))
        sp, t = (_var(schema, y, n) for n in ("SP", "T"))
        log(f"    against the physical input state: dry-air mass rel change {bp['mass']:.3e}, "
            f"water {bp['water']:.3e}, energy {bp['energy']:.3e}; fixed SP "
            f"[{sp.min().item():.4g}, {sp.max().item():.4g}] Pa, T [{t.min().item():.4g}, "
            f"{t.max().item():.4g}] K")
        if not ok:
            raise AssertionError(f"CONF_025_POST step {s}: a fixer's budget is off")
    rec.steps.clear()
    if profile:
        profile_steps(torch, "CONF_025_POST RolloutEngine step",
                      lambda: engine.run(x0, 2, forcing_provider=lambda s: forcing[s],
                                         on_step=lambda s, y: None), (), steps=2)
        rec.steps.clear()
    engine.close()
    return counts


def y_bytes(schema, h: int, w: int) -> int:
    """Bytes of one f32 prediction (B = 1, T = 1) that RolloutEngine.run
    hands to the host."""
    return 4 * h * w * schema.n_target


def _var(schema, flat, name: str, target: bool = True):
    from credit_torch.postblock import _VarView

    return _VarView(schema, name, target).get(flat)


def tools_path(torch) -> dict:
    """Main path 6: the port's tool benches at full size, each bench line's
    launches counted and checked; returns the counts of all of them."""
    from credit_torch.tools import bench_conv, bench_conv_ffk

    total = {}
    _zero_counts()
    rows = bench_conv.run(th=24, iters=3)
    counts = _read_counts()
    calls = {r["name"].split(" ")[0]: r["calls"] for r in rows}
    want = {"conv2d_valid": calls["conv2d_valid"], "conv_band_dma": calls["dma"],
            "conv_band_halo": calls["blocked"]}
    for r in rows:
        log(f"  bench_conv {r['name']:14s}: {r['ms']:8.3f} ms ({r['tflops']:6.1f} TF/s) "
            f"rel_err {r['rel_err']:.2e}")
    log(f"  bench_conv launches {counts}")
    _check_counts(counts, want, 1)
    if not all(r["rel_err"] <= 1e-2 for r in rows):
        raise AssertionError("bench_conv: an implementation disagrees with the plain version")
    total.update(counts)
    for mode in FFK_MODES:
        _zero_counts()
        r = bench_conv_ffk.run([mode], iters=2)[0]
        counts = _read_counts()
        log(f"  bench_conv_ffk {mode:15s}: {r['ms']:8.2f} ms per (conv + 4 FF), output "
            f"{r['shape']} finite {r['finite']}, launches {counts}")
        _check_counts(counts, bench_conv_ffk.launches_per_call(mode), r["calls"])
        if r["shape"] != (1, 400, 720, 128) or not r["finite"]:
            raise AssertionError(f"bench_conv_ffk {mode}: output {r['shape']}, finite {r['finite']}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    return total


def rollout_path(torch, name: str, model_conf: dict, data: dict, want: dict,
                 profile: bool = False, times: dict = None, steps: int = ROLLOUT_STEPS,
                 repeats: int = ROLLOUT_REPEATS) -> dict:
    """A bf16 forecast of `model_conf` on seeded folded weights at batch 1:
    a warm-up step, then `steps` steps whose kernel launches are counted
    and checked against `want` per step, then `repeats` more such rollouts
    timed for the spread; returns the counts and puts the first rollout's
    ms/step into `times[name]`."""
    from credit_torch.convert_jax import init_folded
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.rollout import make_scan_rollout

    conf = {"model": model_conf, "data": data}
    frames = model_conf.get("frames", 1)
    h, w = model_conf["image_height"], model_conf["image_width"]
    schema = ChannelSchema.from_config(conf)
    t0 = time.time()
    model = init_folded(conf, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    model = model.to(torch.bfloat16)  # weights cast once, as the JAX bench does
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in model.parameters())
    log(f"  {name} model: {nparam} parameters, init+converge+fold {time.time() - t0:.1f} s")
    if schema.n_input != model.base_input_channels:
        raise AssertionError((schema.n_input, model.base_input_channels))
    g = torch.Generator(device="cuda").manual_seed(0)
    x0 = (torch.randn((1, frames, h, w, schema.n_input), generator=g, device="cuda")
          * 0.5).to(torch.bfloat16)

    warm = make_scan_rollout(model, schema, 1, history_len=frames, device="cuda")
    t0 = time.time()
    warm(x0)
    torch.cuda.synchronize()
    log(f"  warm-up step: {(time.time() - t0) * 1e3:.1f} ms")

    run = make_scan_rollout(model, schema, steps, history_len=frames, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    final_x, stats = run(x0)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    if times is not None:
        times[name] = elapsed * 1e3 / steps
    log(f"  {name} rollout {steps} steps: {elapsed * 1e3 / steps:.1f} ms/step, "
        f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB; {base} allocated before it), "
        f"launches {counts}")
    _check_counts(counts, want, steps)
    if final_x.shape != x0.shape or stats.shape != (steps, model.base_output_channels):
        raise AssertionError((tuple(final_x.shape), tuple(stats.shape)))
    fin = torch.isfinite(final_x).all().item() and torch.isfinite(stats).all().item()
    amax = final_x.float().abs().max().item()
    log(f"  final state finite: {fin}, max |x| {amax:.3e}; per-step channel means "
        f"range [{stats.float().min().item():.3e}, {stats.float().max().item():.3e}]")
    if not fin:
        raise AssertionError("rollout produced non-finite values")
    spread = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.time()
        run(x0)
        torch.cuda.synchronize()
        spread.append((time.time() - t0) * 1e3 / steps)
    if repeats:
        log(f"  {repeats} more rollouts of {steps} steps: "
            + ", ".join(f"{v:.1f}" for v in spread) + " ms/step")
    if profile:
        profile_steps(torch, f"{name} rollout step",
                      make_scan_rollout(model, schema, 2, history_len=frames, device="cuda"),
                      (x0,), steps=2)
    return counts


def train_path(torch, name: str, model_conf: dict, data: dict, want: dict,
               profile: bool = False, steps: int = TRAIN_STEPS) -> dict:
    """`steps` training steps of `model_conf` (seeded f32 weights with
    spectral-norm state, its bf16 compute, MSE, AdamW(0.9, 0.95) at lr 1e-4,
    forecast_len 1, batch 1, its frames as history) after a warm-up step;
    the launches are counted and checked against `want` per step; returns
    the counts."""
    from credit_torch.convert_jax import init_train
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.losses import WeightedLoss
    from credit_torch.trainers.scheduler import constant
    from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step

    conf = {"model": model_conf, "data": data, "trainer": TRAINER}
    frames = model_conf.get("frames", 1)
    h, w = model_conf["image_height"], model_conf["image_width"]
    schema = ChannelSchema.from_config(conf)
    t0 = time.time()
    model = init_train(conf, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    if schema.n_target != model.base_output_channels:
        raise AssertionError((schema.n_target, model.base_output_channels))
    nparam = sum(p.numel() for p in model.parameters())
    log(f"  {name} training model: {nparam} f32 parameters with spectral-norm state, "
        f"init+converge {time.time() - t0:.1f} s")
    optimizer = make_optimizer(conf, constant(TRAINER["learning_rate"]))
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, WeightedLoss(base="mse"), optimizer, schema, forecast_len=1,
                           history_len=frames, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"x": torch.randn((1, frames, h, w, schema.n_input), generator=g,
                              device="cuda") * 0.5,
             "y": torch.randn((1, 1, h, w, schema.n_target), generator=g, device="cuda") * 0.5}
    t0 = time.time()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    log(f"  warm-up step: {(time.time() - t0) * 1e3:.1f} ms, loss {float(m['loss']):.6f}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, norms = [float(v) for v in losses], [float(v) for v in norms]
    log(f"  {name} training step: {elapsed * 1e3 / steps:.1f} ms/step over "
        f"{steps} steps, peak memory {peak} bytes ({peak / 2**30:.2f} GiB; {base} "
        f"allocated before it), launches {counts}")
    log(f"  losses {losses}, grad norms {norms}")
    _check_counts(counts, want, steps)
    if not all(math.isfinite(v) for v in losses + norms) or state.step != steps + 1:
        raise AssertionError("training produced a non-finite loss or gradient norm")
    if profile:
        profile_steps(torch, f"{name} training step", lambda b: step(state, b), (batch,),
                      steps=1)
    return counts


def write_store(torch, root: str, data: dict, shape, n_times: int, seed: int) -> tuple:
    """A seeded zarr ERA5 store of the data section's variables at `shape`
    (lat, lon), through the port's zarrlite.write_array: (time, level, lat,
    lon) 3-D variables, one zlib chunk per (time, level) slab as ERA5 stores
    are chunked, (time, lat, lon) 2-D ones, (lat, lon) statics, a `level`
    coordinate (the source's levels) and a six-hourly `time` axis in hours
    since 1979-01-01. Values are N(mean, std) in physical units around
    STATS (per level for 3-D variables; (0, 1) for the rest), drawn on the
    card; the arrays are compressed and written on 8 threads, one variable
    each. Also the mean/std netCDF files of those statistics (the port's
    ncio). Returns (mean path, std path)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from credit_torch.data import zarrlite
    from credit_torch.utils.ncio import Dataset

    src = data["source"]["ERA5"]
    levels, variables = src["levels"], src["variables"]
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    mean, std = {}, {}
    os.makedirs(root, exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        jobs = []
        for group, kinds in variables.items():
            for kind, names in kinds.items():
                for name in names:
                    m, sd = STATS.get(name, (0.0, 1.0))
                    lev = len(levels) if kind == "vars_3D" else 1
                    mean[name] = m + 0.05 * sd * rng.standard_normal(lev)
                    std[name] = sd * (1 + 0.1 * rng.uniform(size=lev))
                    if group == "static":
                        dims, chunks = shape, shape
                    elif kind == "vars_3D":
                        dims, chunks = (n_times, lev, *shape), (1, 1, *shape)
                    else:
                        dims, chunks = (n_times, *shape), (1, *shape)
                    m_t = torch.as_tensor(mean[name], dtype=torch.float32, device="cuda")
                    s_t = torch.as_tensor(std[name], dtype=torch.float32, device="cuda")
                    if kind == "vars_3D":
                        m_t, s_t = m_t[:, None, None], s_t[:, None, None]
                    arr = (torch.randn(dims, generator=g, device="cuda") * s_t + m_t).cpu().numpy()
                    jobs.append(pool.submit(zarrlite.write_array, root, name, arr, chunks=chunks))
        for j in jobs:
            j.result()
    zarrlite.write_array(root, "level", np.asarray(levels))
    zarrlite.write_array(root, "time", np.arange(n_times, dtype=np.int64) * 6,
                         attrs={"units": "hours since 1979-01-01", "calendar": "standard"})
    paths = []
    for kind, table in (("mean", mean), ("std", std)):
        paths.append(os.path.join(root, f"{kind}.nc"))
        Dataset({v: (("level",), a.astype(np.float32)) if a.size > 1 else ((), np.float32(a[0]))
                 for v, a in table.items()}).to_netcdf(paths[-1])
    return tuple(paths)


def fit_conf(model: dict, data: dict, store: str, stats, save_loc: str, trainer: dict,
             train_window, valid_window) -> dict:
    """A `credit train` config (a dict, no YAML): the zarr source on the
    store, a training and a later validation clock window, forecast_len 1,
    history_len 1, the Normalizer from the netCDF statistics, the
    latitude-weighted MSE."""
    src = {**data["source"]["ERA5"], "dataset_type": "zarr", "store_path": store}

    def section(window, **kw):
        return {"source": {"ERA5": src}, "start_datetime": window[0],
                "end_datetime": window[1], "timestep": "6h", "forecast_len": 1,
                "history_len": 1, **kw}

    return {"model": model, "save_loc": save_loc, "seed": 0,
            "data": section(train_window, mean_path=stats[0], std_path=stats[1]),
            "data_valid": section(valid_window),
            "loss": {"training_loss": "mse", "use_latitude_weights": True},
            "trainer": trainer}


def read_log(path: str):
    import csv

    with open(os.path.join(path, "training_log.csv")) as f:
        return list(csv.reader(f))


def tiny_fit(torch) -> None:
    """Phase 3's fits: the tiny CrossFormer (f32) for 2 epochs of 2 steps and
    1 validation batch through run_training on a seeded 32x64 zarr store,
    on the card (pinned batches copied asynchronously, validation on the
    EMA weights there) against the same run on the CPU, as it is and with
    TINY_PREBLOCKS in the train and eval steps: every training_log.csv cell
    but `seconds` within TINY_FIT_TOL relative to itself, and with the
    preblocks relative to the largest of its metric in the row (their fit's
    anomaly correlations sit near 0, where the CPU alone on 1 and 6 threads
    parts by 2.8e-4 of a -7.6e-4 cell). Then tiny_rollout from the card's
    checkpoint."""
    from credit_torch.applications import run_training

    root = os.path.join(HERE, "build", "fit_tiny")
    shutil.rmtree(root, ignore_errors=True)
    data = {"source": {"ERA5": {**TINY_DATA["source"]["ERA5"], "levels": [500.0, 850.0]}}}
    stats = write_store(torch, os.path.join(root, "era5.zarr"), data, (32, 64), 8, seed=5)
    trainer = {**FIT_TRAINER, "batches_per_epoch": 2, "learning_rate": 1e-3}
    for what, extra in (("", {}), (" with preblocks", {"preblocks": TINY_PREBLOCKS})):
        logs = {}
        for dev in ("cpu", "cuda"):
            conf = fit_conf(TINY, data, os.path.join(root, "era5.zarr"), stats,
                            os.path.join(root, dev + what.replace(" ", "_")), trainer,
                            ("1979-01-01T00", "1979-01-01T18"), ("1979-01-02T00", "1979-01-02T12"))
            conf.update(extra)
            run_training(conf, device=dev)
            logs[dev] = read_log(conf["save_loc"])
        header = logs["cpu"][0]
        cell, kind = (0.0, ""), 0.0
        for grow, crow in zip(logs["cuda"][1:], logs["cpu"][1:]):
            cols = [(n, float(a), float(b)) for n, a, b in zip(header, grow, crow)
                    if n != "seconds"]
            scale = {}
            for n, _, b in cols:
                scale[_kind(n)] = max(scale.get(_kind(n), 1e-12), abs(b))
            for n, a, b in cols:
                cell = max(cell, (abs(a - b) / max(abs(b), 1e-12), n))
                kind = max(kind, abs(a - b) / scale[_kind(n)])
        ok = logs["cuda"][0] == header and len(logs["cuda"]) == len(logs["cpu"]) == 3
        log(f"  tiny 2-epoch run_training{what} on a 32x64 zarr store, f32 card vs CPU: "
            f"{len(header)} log columns, worst cell rel err {cell[0]:.3e} ({cell[1]}), worst "
            f"cell against its metric's largest in the row {kind:.3e}; limit {TINY_FIT_TOL:g} "
            f"{'on the latter' if extra else 'on the former'}")
        if not (ok and (kind if extra else cell[0]) <= TINY_FIT_TOL):
            raise AssertionError(f"tiny fit{what} on the card disagrees with the CPU")
    tiny_rollout(conf)
    tiny_ensemble_apps(torch, conf)
    shutil.rmtree(root, ignore_errors=True)


def _kind(column: str) -> str:
    """A training_log.csv column's metric: its split and kind
    ('valid_acc' for valid_acc_T_L1)."""
    return "_".join(column.split("_")[:2])


def tiny_rollout(conf: dict) -> None:
    """run_rollout from the card's tiny checkpoint (EMA weights), two init
    times of 2 steps, on the card and on the CPU: the same 4 files, each
    variable within TINY_FIT_TOL of its maximum by the port's
    diff_rollout."""
    from credit_torch.applications import diff_rollout, run_rollout

    paths, out = {}, {}
    for dev in ("cpu", "cuda"):
        out[dev] = os.path.join(conf["save_loc"], f"forecast_{dev}")
        run = {**conf, "predict": {
            "forecasts": {"start_year": 1979, "start_month": 1, "start_day": 1,
                          "start_hours": [0, 6], "duration": 1},
            "forecast_steps": 2, "save_forecast": out[dev]}}
        paths[dev] = run_rollout(run, use_ema=True, device=dev)
    names = sorted(os.path.relpath(p, out["cuda"]) for p in paths["cuda"])
    report = diff_rollout(paths["cuda"], out["cpu"], rtol=TINY_FIT_TOL, atol=TINY_FIT_TOL)
    worst = max((v.get("rel", math.inf) for r in report for v in r.get("vars", {}).values()),
                default=math.inf)
    log(f"  tiny run_rollout, 2 init times x 2 steps, f32 card vs CPU: files {names}, worst "
        f"variable rel err {worst:.3e} limit {TINY_FIT_TOL:g} (diff_rollout)")
    if (len(names) != 4 or names != sorted(os.path.relpath(p, out["cpu"]) for p in paths["cpu"])
            or not all(r["ok"] for r in report)):
        raise AssertionError("the tiny rollout on the card disagrees with the CPU")


def _rel(a, b) -> float:
    """max |a - b| over max |b|, on the host."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _rows_err(got: list, want: list) -> float:
    """The worst row value of `got` against `want`: relative, the anomaly
    correlations (acc) absolute (they sit near 0); inf where the rows'
    keys or counts differ or a value is not finite."""
    if [sorted(r) for r in got] != [sorted(r) for r in want]:
        return math.inf
    worst = 0.0
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, str):
                if g[k] != v:
                    return math.inf
                continue
            for a, b in zip(g[k] if isinstance(v, list) else [g[k]],
                            v if isinstance(v, list) else [v]):
                if not (math.isfinite(a) and math.isfinite(b)):
                    return math.inf
                scale = 1.0 if "acc" in k else max(abs(b), 1e-12)
                worst = max(worst, abs(a - b) / scale)
    return worst


def tiny_ensemble_apps(torch, conf: dict) -> None:
    """Phase 3's ensemble slice, tiny and f32, on the card against the CPU
    with the same draws (every ensemble draw comes from a CPU generator):
    the four noise classes on a 32x64 state; one bred vector of the tiny
    fit's engine step; an SDL capture replayed on the other device and a
    capture on the card replayed bitwise; run_rollout from the tiny fit's
    checkpoint with ensemble_size 3 (2 members + control, 2 steps, gaussian
    and bred), the files by diff_rollout; rollout_metrics' rows (3 members,
    2 steps, gaussian and bred); ensemble_eval's rows over the gaussian
    tree; 5 ic-opt iterations of the tiny model (losses and x0); ptype's
    fields from a seeded classifier on the control's first file. Each
    within TINY_FIT_TOL."""
    import numpy as np

    from credit_torch.applications import diff_rollout, experiment, run_rollout
    from credit_torch.applications.ensemble_eval import evaluate_tree, flat_from_netcdf
    from credit_torch.applications.rollout_metrics import run_rollout_metrics
    from credit_torch.convert_jax import init_folded
    from credit_torch.ensemble import bred_vector
    from credit_torch.ensemble.noise import ColorNoise, GaussianNoise, SphericalNoise, TemporalNoise
    from credit_torch.ensemble.sdl_wrapper import SDLInferenceWrapper
    from credit_torch.grid import Grid
    from credit_torch.ptype import PTypeClassifier
    from credit_torch.trainers.ic_optimization import optimize_initial_condition
    from credit_torch.utils.ncio import open_dataset

    errs = {}
    x = torch.randn((2, 3, 32, 64, 4), generator=torch.Generator().manual_seed(8))
    chol = torch.tril(torch.rand((4, 4), generator=torch.Generator().manual_seed(9))) + torch.eye(4)
    for name, gen in (("gaussian", GaussianNoise(0.1)),
                      ("spherical", SphericalNoise(Grid.regular(32, 64), 0.1)),
                      ("color", ColorNoise(0.1, chol=chol.numpy())),
                      ("temporal", TemporalNoise(0.1, rho=0.7))):
        cpu = gen(torch.Generator().manual_seed(10), x)
        errs[f"noise {name}"] = _rel(gen(torch.Generator().manual_seed(10), x.cuda()), cpu)

    root = os.path.dirname(conf["save_loc"])
    engines = {dev: experiment._load_engine(conf, torch.device(dev), use_ema=True)
               for dev in ("cpu", "cuda")}
    exp = engines["cpu"][0]
    t0 = exp["dataset"].history_len
    x0 = exp["normalizer"].normalize_input(torch.as_tensor(exp["dataset"].input_at(t0)[None]))
    bvs = {dev: bred_vector.generate_bred_vectors(
        lambda s, e=e: e.fresh_step(s)[1], x0.to(dev), torch.Generator().manual_seed(11), 1,
        amplitude=0.05, n_cycles=2)[0] for dev, (_, e) in engines.items()}
    errs["bred vector"] = _rel(bvs["cuda"] - x0.cuda(), bvs["cpu"] - x0)

    for _, e in engines.values():
        e.close()
    # ic-opt on the tiny fit's folded weights: 2 steps, 5 iterations
    ds = exp["dataset"]
    norm, schema = exp["normalizer"], exp["schema"]
    targets = norm.normalize_target(torch.as_tensor(
        np.stack([ds.target_at(t0 + 1 + s)[0] for s in range(2)])[None]))
    forcing = norm.normalize_forcing(torch.as_tensor(
        np.stack([ds.forcing_at(t0 + s)[0] for s in range(2)])[None]), schema)
    icopt = {dev: optimize_initial_condition(e.model, schema, x0, targets, forcing, n_steps=2,
                                             iterations=5, learning_rate=1e-2, device=dev)
             for dev, (_, e) in engines.items()}
    errs["ic-opt losses"] = _rel(torch.tensor(icopt["cuda"][1]), torch.tensor(icopt["cpu"][1]))
    errs["ic-opt x0"] = _rel(icopt["cuda"][0], icopt["cpu"][0])
    falls = icopt["cuda"][1][-1] < icopt["cuda"][1][0]
    del engines

    # the SDL wrapper on the tiny crossformer-ensemble, folded
    sconf = {"model": {**TINY, "type": "crossformer-ensemble"}, "data": TINY_DATA}
    wrappers = {dev: SDLInferenceWrapper(init_folded(sconf, torch.Generator().manual_seed(7),
                                                     device=dev)) for dev in ("cpu", "cuda")}
    xs = torch.randn((2, 1, 32, 64, 7), generator=torch.Generator().manual_seed(12))
    y_cpu, lat = wrappers["cpu"].forward(xs, generator=torch.Generator().manual_seed(13),
                                         capture=True)
    errs["SDL replay"] = _rel(wrappers["cuda"].forward(
        xs.cuda(), latents={k: v.cuda() for k, v in lat.items()}), y_cpu)
    y_card, lat_card = wrappers["cuda"].forward(
        xs.cuda(), generator=torch.Generator(device="cuda").manual_seed(13), capture=True)
    sdl_bitwise = torch.equal(wrappers["cuda"].forward(xs.cuda(), latents=lat_card), y_card)
    del wrappers

    trees, paths = {}, {}
    for pert in ("gaussian", "bred"):
        for dev in ("cpu", "cuda"):
            trees[pert, dev] = os.path.join(root, f"ens_{pert}_{dev}")
            run = {**conf, "predict": {
                "forecasts": {"start_year": 1979, "start_month": 1, "start_day": 1,
                              "start_hours": [6], "duration": 1},
                "forecast_steps": 2, "save_forecast": trees[pert, dev], "ensemble_size": 3,
                "perturbation": pert, "perturbation_std": 0.05, "bred_cycles": 2, "seed": 1}}
            paths[pert, dev] = run_rollout(run, use_ema=True, device=dev)
        report = diff_rollout(paths[pert, "cuda"], trees[pert, "cpu"], rtol=TINY_FIT_TOL,
                              atol=TINY_FIT_TOL)
        errs[f"run_rollout {pert}"] = max(
            (v.get("rel", math.inf) for r in report for v in r.get("vars", {}).values()),
            default=math.inf)
        if not all(r["ok"] for r in report) or len(report) != 6:
            errs[f"run_rollout {pert}"] = math.inf
    dirs = sorted(os.listdir(trees["gaussian", "cuda"]))

    for pert in ("gaussian", "bred"):
        mconf = {**conf, "predict": {"forecast_steps": 2, "ensemble": {
            "amplitude": 0.05, "size": 3, "perturbation": pert}}}
        rows = {dev: run_rollout_metrics(mconf, device=dev) for dev in ("cpu", "cuda")}
        errs[f"rollout_metrics {pert}"] = _rows_err(rows["cuda"], rows["cpu"])
    rows = {dev: evaluate_tree(conf, trees["gaussian", "cuda"], device=dev)
            for dev in ("cpu", "cuda")}
    errs["ensemble_eval"] = _rows_err(rows["cuda"], rows["cpu"])

    # ptype from the control's first file: T at the 2 levels, a dewpoint
    # depression of |U| (the tiny data has no humidity)
    control = sorted(p for p in paths["gaussian", "cuda"] if "_e0" not in p)[0]
    flat = torch.as_tensor(flat_from_netcdf(open_dataset(control), schema))
    t = flat[..., [schema.target_names.index(f"T_L{i}") for i in range(2)]]
    td = t - flat[..., [schema.target_names.index(f"U_L{i}") for i in range(2)]].abs()
    fields = {}
    for dev in ("cpu", "cuda"):
        clf = PTypeClassifier(hidden=(16, 16), device=dev)
        clf.init(torch.Generator().manual_seed(14), 4)
        fields[dev] = clf(t, td)
    errs["ptype"] = max(_rel(torch.from_numpy(fields["cuda"][k]), torch.from_numpy(v))
                        for k, v in fields["cpu"].items() if not k.startswith("ML_c"))
    for pert in ("gaussian", "bred"):
        for dev in ("cpu", "cuda"):
            shutil.rmtree(trees[pert, dev], ignore_errors=True)
    worst = max(errs.values())
    readings = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    log(f"  tiny ensemble slice, f32 card vs CPU, same draws: {readings}; "
        f"limit {TINY_FIT_TOL:g}; member directories {dirs}; ic-opt loss falls {falls}; "
        f"the card's SDL capture replayed bitwise {sdl_bitwise}")
    if not (worst <= TINY_FIT_TOL and falls and sdl_bitwise and len(dirs) == 3):
        raise AssertionError("the tiny ensemble slice on the card disagrees with the CPU")


def fit_path(torch, want_train: dict, want_valid: dict) -> tuple:
    """Main path 7, `credit train` at CONF_025: the store, run_training for
    FIT_EPOCHS epochs, then a resumed run of 1 epoch under the profiler, each
    checked, the store read through the native chunk pool. Returns the
    first run's launch counts and (store, statistics, data section, run
    directory) for main paths 8 to 10; main path 10 removes them."""
    from credit_torch.applications import prepare_training
    from credit_torch.data import zarrlite
    from credit_torch.native import fastload
    from credit_torch.trainers.trainer import Trainer

    root = os.path.join(HERE, "build", "fit_025")
    shutil.rmtree(root, ignore_errors=True)
    store = os.path.join(root, "era5.zarr")
    data = {"source": {"ERA5": {**DATA_025["source"]["ERA5"], "levels": FIT_LEVELS}}}
    h, w = CONF_025["image_height"], CONF_025["image_width"]
    t0 = time.time()
    stats = write_store(torch, store, data, (h, w), FIT_TIMES, seed=0)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(store) for f in fs)
    log(f"  store: {FIT_TIMES} times x {len(FIT_LEVELS)} levels at {h}x{w}, {size} bytes "
        f"written in {time.time() - t0:.1f} s (zlib level 1, 8 writer threads)")
    conf = fit_conf(CONF_025_TRAIN, data, store, stats, os.path.join(root, "run"),
                    {**FIT_TRAINER, "num_epoch": FIT_EPOCHS}, *FIT_WINDOWS)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    read0, pool0 = zarrlite.chunks_read, fastload.decoded
    t0 = time.time()
    trainer, state, start, seed = prepare_training(conf)
    log(f"  run_training set-up (data, model, trainer, seeded weights): {time.time() - t0:.1f} s")
    state = trainer.fit(state, seed=seed, start_epoch=start)
    torch.cuda.synchronize()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    read, pool = zarrlite.chunks_read - read0, fastload.decoded - pool0
    log(f"  chunk pool (credit_torch/native/fastload.cpp): {fastload.default_threads()} threads "
        f"(os.cpu_count() {os.cpu_count()}); chunks decoded by the pool {pool} of {read} read")
    if pool != read or read == 0:
        raise AssertionError(f"{read - pool} of {read} chunks bypassed the native pool")
    log(f"  run_training {FIT_EPOCHS} epoch(s): {time.time() - t0:.1f} s end to end, peak memory "
        f"{peak} bytes "
        f"({peak / 2**30:.2f} GiB), launches {counts}; preflight and warm-up add none (the "
        f"preflight reads a host sample only, the weights are seeded without a forward)")
    fit_times(trainer)
    per_epoch = FIT_TRAINER["batches_per_epoch"]
    n_steps = FIT_EPOCHS * per_epoch
    _check_counts(counts, {k: n_steps * want_train.get(k, 0) + FIT_EPOCHS * want_valid.get(k, 0)
                           for k in counts}, 1)
    rows = read_log(conf["save_loc"])
    header, body = rows[0], rows[1:]
    names = trainer.schema.target_names
    need = [f"{split}_{kind}_{n}" for split in ("train", "valid")
            for kind in ("mse", "rmse", "mae", "acc") for n in names]
    missing = [c for c in need if c not in header]
    losses = [(float(r[1]), float(r[2])) for r in body]
    log(f"  training_log.csv: {len(body)} rows, {len(header)} columns ({len(need)} per-variable "
        f"columns for {len(names)} targets, missing {missing[:4]}); (train, valid) loss by epoch "
        f"{losses}")
    if (len(body) != FIT_EPOCHS or len(names) != 64 or missing
            or not all(math.isfinite(v) for pair in losses for v in pair)):
        raise AssertionError("the CONF_025 fit's log is incomplete or not finite")
    run = conf["save_loc"]
    # (backup_checkpoint/ comes with the second save: checked after the resume)
    for name in ("checkpoint", "best"):
        if not os.path.exists(os.path.join(run, name, Trainer.CHECKPOINT_FILE)):
            raise AssertionError(f"no {name}/ after the fit")
    for name in ("epoch.txt", "channel_schema.json"):
        if not os.path.exists(os.path.join(run, name)):
            raise AssertionError(f"no {name} after the fit")
    saved = torch.load(os.path.join(run, "checkpoint", Trainer.CHECKPOINT_FILE),
                       map_location="cpu", weights_only=True)
    del state, trainer
    torch.cuda.empty_cache()

    resume = {**conf, "trainer": {**FIT_TRAINER, "load_weights": True, "num_epoch": 1}}
    _zero_counts()
    trainer, state, start, seed = prepare_training(resume)
    same = all(torch.equal(v.cpu(), saved["model"][k]) for k, v in state.model.state_dict().items())
    same = same and all(torch.equal(v.cpu(), saved["ema_params"][k])
                        for k, v in state.ema_params.items())
    log(f"  resume: state at step {state.step}, epoch {start}; parameters, u/v and EMA bitwise "
        f"equal to the checkpoint before the first step: {same}")
    if not same or state.step != n_steps or start != FIT_EPOCHS:
        raise AssertionError("the resumed state is not the saved one")
    done = {}

    def resumed():
        done["state"] = trainer.fit(state, seed=seed, start_epoch=start)

    idle = profile_steps(torch, "CONF_025 resumed fit epoch", resumed, (), steps=1)
    state_step = done["state"].step
    torch.cuda.synchronize()
    counts2 = _read_counts()
    log(f"  resumed run: launches {counts2}, step now {state_step}")
    fit_times(trainer)
    _check_counts(counts2, {k: per_epoch * want_train.get(k, 0) + want_valid.get(k, 0)
                            for k in counts2}, 1)
    rows = read_log(run)
    if ([r[0] for r in rows[1:]] != [str(e) for e in range(FIT_EPOCHS + 1)]
            or state_step != n_steps + per_epoch):
        raise AssertionError(f"the resumed run did not continue: epochs {[r[0] for r in rows[1:]]}")
    if not os.path.exists(os.path.join(run, "backup_checkpoint", Trainer.CHECKPOINT_FILE)):
        raise AssertionError("no backup_checkpoint/ after the resumed fit")
    log(f"  resumed epoch (profiled) idle share {idle:.3f}; phase 10 before the chunk pool: "
        f"{ONE_THREAD_FIT}")
    assembly_breakdown(trainer)
    del state, trainer, saved, done
    return counts, (store, stats, data, run)


def assembly_breakdown(trainer) -> None:
    """One training batch assembled on this thread while the card idles,
    through the native pool: the whole (`dataset.batch` and pinning), the
    time inside the zarr reads and, of it, inside the pool's read and
    inflate; the rest is `_stack`'s copies and the pinning. (The Python
    path, chunk by chunk as the reader did before the pool, read 8.2-10.2 s
    a batch against the pool's 5.1-6.4 in PR 19's calls 4-5; cut for the
    script's time.)"""
    from credit_torch.data import zarrlite
    from credit_torch.native import fastload

    spent = {}

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    read, pool = zarrlite.ZarrArray.read, fastload.read_decode_batch
    zarrlite.ZarrArray.read = timed("read", read)
    fastload.read_decode_batch = timed("pool", pool)
    try:
        spent.update(read=0.0, pool=0.0)
        t0 = time.perf_counter()
        raw = trainer.dataset.batch([0], 1)
        batch = {k: trainer._host_tensor(k, v) for k, v in raw.items() if v is not None}
        whole = (time.perf_counter() - t0) * 1e3
        nbytes = sum(v.numel() * v.element_size() for v in batch.values())
        log(f"  one batch ({nbytes} bytes) assembled alone, native pool: {whole:.0f} ms; zarr "
            f"reads {spent['read'] * 1e3:.0f} ms (the pool's read and inflate "
            f"{spent['pool'] * 1e3:.0f} ms); stacking and pinning "
            f"{whole - spent['read'] * 1e3:.0f} ms")
    finally:
        zarrlite.ZarrArray.read, fastload.read_decode_batch = read, pool


def ensemble_fit_path(torch, store_info, want_train: dict, want_valid: dict) -> dict:
    """Main path 8, ensemble CRPS training at CONF_025 width: run_training
    (prepare_training + fit) of CONF_025_ENS on main path 7's store for one
    epoch of ENS_TRAINER. Checks: the log finite in every cell, the
    parameters bitwise unchanged by the first micro-step and changed by the
    second (grad_accum_every 2), the two members of the validation batch
    apart, the launches (2 micro-steps of 2 members and a 2-member
    validation forward); prints the step, validation and assembly times
    and the peak memory. Returns the launch counts."""
    from credit_torch.applications import prepare_training

    store, stats, data, _ = store_info
    root = os.path.dirname(store)
    conf = fit_conf(CONF_025_ENS, data, store, stats, os.path.join(root, "ens"), ENS_TRAINER,
                    *ENS_WINDOWS)
    conf["loss"] = ENS_LOSS
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.time()
    trainer, state, start, seed = prepare_training(conf)
    log(f"  set-up (data, crossformer-ensemble model, trainer, seeded weights): "
        f"{time.time() - t0:.1f} s; {sum(p.numel() for p in trainer.model.parameters())} f32 "
        f"parameters")
    params = list(trainer.model.parameters())
    step, unchanged = trainer._train_step_for(1), []

    def watched(state, batch):
        # the first two micro-steps: the parameters before and after, on the host
        before = ([p.detach().to("cpu", copy=True) for p in params] if len(unchanged) < 2
                  else None)
        out = step(state, batch)
        if before is not None:
            unchanged.append(all(torch.equal(p.detach().cpu(), b) for p, b in zip(params, before)))
        return out

    trainer._step_cache[1] = watched
    spread = []

    def members(module, args, out):
        if not module.training:  # validation: batch 1, members 0 and 1
            spread.append((out[0] - out[1]).abs().max().item())

    hook = trainer.model.register_forward_hook(members)
    state = trainer.fit(state, seed=seed, start_epoch=start)
    torch.cuda.synchronize()
    hook.remove()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  run_training 1 epoch: {time.time() - t0:.1f} s end to end, peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB), launches {counts}")
    fit_times(trainer)
    log(f"  parameters unchanged by micro-step 1, by micro-step 2: {unchanged} (expected "
        f"[True, False]); validation members apart by {spread}; step {state.step}, optimizer "
        f"count {state.opt_state['count']}")
    rows = read_log(conf["save_loc"])
    cells = [float(c) for r in rows[1:] for c in r[1:]]
    log(f"  training_log.csv: {len(rows) - 1} row, {len(rows[0])} columns, (train, valid) loss "
        f"{[(float(r[1]), float(r[2])) for r in rows[1:]]}")
    if (unchanged != [True, False] or not spread or not all(v > 0 for v in spread)
            or len(rows) != 2 or not all(math.isfinite(v) for v in cells)
            or state.step != 2 or state.opt_state["count"] != 1):
        raise AssertionError("the CONF_025 ensemble fit failed its checks")
    _check_counts(counts, {k: 2 * want_train.get(k, 0) + want_valid.get(k, 0) for k in counts}, 1)
    del state, trainer, params, step
    shutil.rmtree(conf["save_loc"], ignore_errors=True)
    return counts


def rollout_nc_path(torch, store_info, want: dict) -> dict:
    """Main path 9, `credit rollout` at CONF_025 width: run_rollout of
    phase 10's config over the store's whole clock, from its checkpoint's
    EMA weights, for NC_INIT_HOURS of NC_STEPS steps each, every step
    written to netCDF by the engine's writer threads. Checks the files'
    names, every target variable's dimensions, shape and CF attributes,
    that every value is finite, the launches per step against `want`, and
    the first file of the first init against RolloutEngine.step of the same
    folded weights, denormalized. Prints the wall ms/step with the writes,
    the copy ms, ms and MB per written file and the peak memory. Returns
    the launch counts and the first file's path (phase 13 reads its
    winds)."""
    import numpy as np

    from credit_torch import output, rollout
    from credit_torch.applications import experiment, run_rollout
    from credit_torch.metadata import variable_attrs
    from credit_torch.trainers.trainer import Trainer
    from credit_torch.utils.ncio import open_dataset

    store, stats, data, run = store_info
    root = os.path.dirname(store)
    out = os.path.join(root, "forecasts")
    conf = fit_conf(CONF_025_TRAIN, data, store, stats, run, FIT_TRAINER, NC_WINDOW,
                    FIT_WINDOWS[1])
    conf["predict"] = {"forecasts": {"start_year": 1979, "start_month": 1, "start_day": 1,
                                     "start_hours": list(NC_INIT_HOURS), "duration": 1},
                       "forecast_steps": NC_STEPS, "save_forecast": out}
    runs, files = [], []
    engine_run, save = rollout.RolloutEngine.run, output.save_netcdf_increment

    def timed_run(self, *args, **kw):
        t0 = time.perf_counter()
        res = engine_run(self, *args, **kw)
        runs.append(((time.perf_counter() - t0) * 1e3, list(self.copy_ms)))
        return res

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        path = save(*args, **kw)
        files.append(((time.perf_counter() - t0) * 1e3, os.path.getsize(path)))
        return path

    rollout.RolloutEngine.run, output.save_netcdf_increment = timed_run, timed_save
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    try:
        t0 = time.time()
        paths = run_rollout(conf, use_ema=True)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    finally:
        rollout.RolloutEngine.run, output.save_netcdf_increment = engine_run, save
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = len(NC_INIT_HOURS) * NC_STEPS
    log(f"  run_rollout (use_ema) {len(NC_INIT_HOURS)} init times x {NC_STEPS} steps: "
        f"{wall:.0f} ms end to end, of which set-up (data, trainer, checkpoint, "
        f"converge_spectral and fold) {wall - sum(r[0] for r in runs):.0f} ms; peak memory "
        f"{peak} bytes ({peak / 2**30:.2f} GiB); launches {counts}")
    for (ms, copies), hour in zip(runs, NC_INIT_HOURS):
        log(f"  init {hour:02d} h: {ms / NC_STEPS:.1f} ms/step with the writes (all written when "
            f"run returns); copy ms {[round(v, 2) for v in copies]}")
    fms = [f[0] for f in files]
    log(f"  {len(files)} files written: ms per file min {min(fms):.0f} mean "
        f"{sum(fms) / len(fms):.0f} max {max(fms):.0f}; MB per file {files[0][1] / 1e6:.1f} "
        f"(two writer threads)")
    _check_counts(counts, want, steps)

    names = sorted(os.path.relpath(p, out) for p in paths)
    want_names = sorted(os.path.join(f"1979-01-01T{h:02d}Z", f"pred_1979-01-01T{h:02d}Z_"
                                     f"{6 * (s + 1):03d}.nc")
                        for h in NC_INIT_HOURS for s in range(NC_STEPS))
    if names != want_names:
        raise AssertionError(f"files {names}, expected {want_names}")
    exp = experiment.build_data(conf)
    schema, h, w = exp["schema"], CONF_025["image_height"], CONF_025["image_width"]
    # each target variable's levels (None for a 2-D one), as output.py splits them
    levels = {k: v.shape[1] if v.ndim == 4 else None for k, v in output.split_channels(
        np.zeros((1, 1, 1, schema.n_target), np.float32), schema).items()}
    first = os.path.join(out, want_names[0])
    t0 = time.time()
    for path in sorted(paths):
        ds = open_dataset(path)
        for name, lev in levels.items():
            v = ds[name]
            dims, shape = ((("time", "level", "lat", "lon"), (1, lev, h, w)) if lev
                           else (("time", "lat", "lon"), (1, h, w)))
            if (tuple(v.dims) != dims or v.values.shape != shape
                    or dict(v.attrs) != variable_attrs(name) or not np.isfinite(v.values).all()):
                raise AssertionError(f"{path}: {name} {v.dims} {v.values.shape} {v.attrs}")
        if path == first:
            written = {name: np.asarray(ds[name].values)[0] for name in levels}
    log(f"  every file: {len(levels)} variables with their (time[, level], lat, lon) shape, CF "
        f"attributes and finite values (read back in {time.time() - t0:.1f} s)")

    saved = torch.load(os.path.join(run, "checkpoint", Trainer.CHECKPOINT_FILE),
                       map_location="cuda", weights_only=True)
    model = experiment._inference_model(conf, {**saved["model"], **saved["ema_params"]},
                                        torch.device("cuda"))
    del saved
    engine = rollout.RolloutEngine(model, schema, exp["normalizer"], device="cuda")
    x0 = torch.as_tensor(exp["dataset"].input_at(exp["dataset"].index_of(
        f"1979-01-01T{NC_INIT_HOURS[0]:02d}:00:00"))[None])
    y, _ = engine.step(exp["normalizer"].normalize_input(x0))
    y = exp["normalizer"].denormalize_target(y).float()[0].cpu().numpy()
    engine.close()
    err = max(float(np.abs(a[0] - written[k]).max() / np.abs(written[k]).max())
              for k, a in output.split_channels(y, schema).items())
    log(f"  {want_names[0]} against RolloutEngine.step of the same folded EMA weights, "
        f"denormalized: worst variable rel err {err:.3e} limit {NC_TOL:g} (bf16 compute)")
    if not err <= NC_TOL:
        raise AssertionError("the written forecast disagrees with the engine's step")
    del model, engine
    return counts, first


def tisr_fit_path(torch, store_info, want_train: dict, want_valid: dict) -> dict:
    """Main path 10, `credit train` on computed solar forcing: run_training
    (prepare_training + fit) of CONF_025_TRAIN on main path 7's store with
    tsi from a `tisr` source (SUN_SOURCE) instead of the store, for one
    epoch of TISR_TRAINER (no longer profiled: phase 10's resumed epoch
    reads the idle share, and the run's time went to phases 15-16). tsi's mean and std come from
    the fields of the store's clock, computed on the host as the source
    computes them (tisr_accumulated at the day of year and hour of each
    time). Checks: the first training batch's tsi input and forcing on the
    card bitwise equal to those fields at its init time and the next, the
    log finite, the launches (2 steps and a validation batch). Prints the
    channel order, the host ms of one field, the step, validation,
    assembly and copy times, the tisr fields' share of the assembly and
    the peak memory. Returns the launch counts."""
    import datetime as dt
    import threading

    import numpy as np

    from credit_torch.applications import prepare_training
    from credit_torch.data import tisr
    from credit_torch.grid import Grid
    from credit_torch.physics import solar
    from credit_torch.utils.ncio import Dataset, open_dataset

    store, stats, data, _ = store_info
    root = os.path.dirname(store)
    era5 = data["source"]["ERA5"]
    variables = {**era5["variables"], "dynamic_forcing": {"vars_2D": [
        v for v in era5["variables"]["dynamic_forcing"]["vars_2D"] if v != "tsi"]}}
    store_data = {"source": {"ERA5": {**era5, "variables": variables}}}
    grid = Grid.regular(CONF_025["image_height"], CONF_025["image_width"])

    def host_field(k: int):
        doy, hour = tisr._doy_hour(np.datetime64("1979-01-01T00", "s") + np.timedelta64(6 * k, "h"))
        when = dt.datetime(2001, 1, 1) + dt.timedelta(days=doy - 1, hours=hour)
        return np.asarray(solar.tisr_accumulated(grid.lat, grid.lon, when, 6.0), np.float32)

    t0 = time.perf_counter()
    fields = [host_field(k) for k in range(FIT_TIMES)]
    one_ms = (time.perf_counter() - t0) * 1e3 / FIT_TIMES
    mean, std = float(np.mean(fields, dtype=np.float64)), float(np.std(fields, dtype=np.float64))
    tisr_stats = []
    for kind, path, value in (("mean", stats[0], mean), ("std", stats[1], std)):
        old = open_dataset(path)
        tisr_stats.append(os.path.join(root, f"{kind}_tisr.nc"))
        Dataset({**{k: (old[k].dims, np.asarray(old[k].values)) for k in old.keys()},
                 "tsi": ((), np.float32(value))}).to_netcdf(tisr_stats[-1])
    log(f"  tsi computed on the host (tisr_accumulated, 6-hour accumulation, {grid.nlat}x"
        f"{grid.nlon} in float64): {one_ms:.0f} ms a field; mean {mean:.6e} std {std:.6e} J/m^2 "
        f"over the store's {FIT_TIMES} times, written into the statistics files")
    conf = fit_conf(CONF_025_TRAIN, store_data, store, tisr_stats, os.path.join(root, "tisr"),
                    TISR_TRAINER, *FIT_WINDOWS)
    for split in ("data", "data_valid"):
        conf[split]["source"]["SUN"] = SUN_SOURCE
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.time()
    trainer, state, start, seed = prepare_training(conf)
    schema = trainer.schema
    i_tsi = schema.input_names.index("tsi")
    j_tsi = schema.dynamic_forcing_indices().index(i_tsi)
    log(f"  set-up (data, model, trainer, seeded weights): {time.time() - t0:.1f} s; sources "
        f"{list(trainer.dataset.sources)}, {schema.n_input} inputs, tsi input channel {i_tsi}, "
        f"forcing {[schema.input_names[i] for i in schema.dynamic_forcing_indices()]}")
    step, seen, field_ms = trainer._train_step_for(1), [], []

    def watched(state, batch):
        if not seen:  # the first training batch as it reached the card
            seen.append((batch["x"][0, 0, ..., i_tsi].cpu().numpy(),
                         batch["forcing"][0, 0, ..., j_tsi].cpu().numpy()))
        return step(state, batch)

    field = tisr.TISRDataset._field

    def timed_field(self, t_idx):
        t1 = time.perf_counter()
        try:
            return field(self, t_idx)
        finally:  # the producer threads' batches only, not the preflight's sample
            if threading.current_thread() is not threading.main_thread():
                field_ms.append((time.perf_counter() - t1) * 1e3)

    trainer._step_cache[1] = watched
    done = {}

    def run():
        done["state"] = trainer.fit(state, seed=seed, start_epoch=start)

    tisr.TISRDataset._field = timed_field
    try:
        run()
    finally:
        tisr.TISRDataset._field = field
    torch.cuda.synchronize()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  run_training 1 epoch: {time.time() - t0:.1f} s end to end, peak memory "
        f"{peak} bytes ({peak / 2**30:.2f} GiB), launches {counts}")
    fit_times(trainer)
    assembled = [v for e in trainer.epoch_timings for v in e["assemble_ms"]]
    log(f"  batch assembly host ms mean {sum(assembled) / len(assembled):.0f} over "
        f"{len(assembled)} batches, of which the tisr fields {sum(field_ms):.0f} ms of "
        f"{sum(assembled):.0f} ({sum(field_ms) / sum(assembled):.3f}; {len(field_ms)} fields, "
        f"{sum(field_ms) / max(len(field_ms), 1):.0f} ms each)")
    x_tsi, f_tsi = seen[0]
    match = [k for k, f in enumerate(fields) if np.array_equal(f, x_tsi)]
    same = (len(match) == 1 and match[0] + 1 < FIT_TIMES
            and np.array_equal(fields[match[0] + 1], f_tsi))
    log(f"  first training batch on the card: tsi input bitwise equal to tisr_accumulated at "
        f"clock index {match} (the store's 6-hourly times), its forcing to the next time's: "
        f"{same}")
    rows = read_log(conf["save_loc"])
    cells = [float(c) for r in rows[1:] for c in r[1:]]
    log(f"  training_log.csv: {len(rows) - 1} row, {len(rows[0])} columns, (train, valid) loss "
        f"{[(float(r[1]), float(r[2])) for r in rows[1:]]}")
    if (not same or len(rows) != 2 or not all(math.isfinite(v) for v in cells)
            or done["state"].step != 2):
        raise AssertionError("the CONF_025 fit on computed tsi failed its checks")
    _check_counts(counts, {k: 2 * want_train.get(k, 0) + want_valid.get(k, 0) for k in counts}, 1)
    del state, trainer, step, done
    return counts


def regrid_phase(torch) -> None:
    """The regrid preblock at full size (REGRID_CASES) on a seeded (1, 1, H,
    W, 60) f32 batch: ms per call on the card (its index and weight tables
    moved there at the first call), the same block's output on the CPU
    against the card's within REGRID_TOL of max |x|."""
    from credit_torch.grid import Grid
    from credit_torch.preblock import RegridPreblock
    from credit_torch.tools import cuda_ms

    g = torch.Generator(device="cuda").manual_seed(13)
    for method, src, dst in REGRID_CASES:
        s, d = Grid.regular(*src), Grid.regular(*dst)
        t0 = time.time()
        block = RegridPreblock(src_lat=s.lat, src_lon=s.lon, dst_lat=d.lat, dst_lon=d.lon,
                               method=method)
        build = time.time() - t0
        x = torch.randn((1, 1, *src, 60), generator=g, device="cuda")
        y = block(x)
        ms = cuda_ms(lambda: block(x), 10)
        ref = RegridPreblock(src_lat=s.lat, src_lon=s.lon, dst_lat=d.lat, dst_lon=d.lon,
                             method=method)(x.cpu())
        err = float((y.cpu() - ref).abs().max() / x.abs().max())
        log(f"  regrid {method} {src[0]}x{src[1]} -> {dst[0]}x{dst[1]}, 60 channels: tables "
            f"{build * 1e3:.0f} ms on the host, {ms:.3f} ms a call on the card; card vs CPU "
            f"{err:.3e} of max|x|, limit {REGRID_TOL:g}")
        if tuple(y.shape) != (1, 1, *dst, 60) or not err <= REGRID_TOL:
            raise AssertionError(f"the {method} regrid on the card disagrees with the CPU")


class HostPeak:
    """The process's resident memory, sampled every 10 ms on a thread while
    the block runs: `bytes` is its peak above the level at the start."""

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def __enter__(self):
        import threading

        self.start, self.peak, self._stop = self._rss(), 0, threading.Event()

        def sample():
            while not self._stop.wait(0.01):
                self.peak = max(self.peak, self._rss())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.bytes = max(self.peak, self._rss()) - self.start


def sht_phase(torch, forecast: str) -> None:
    """divergent_rotational_spectra at 0.25 degrees on the U and V (13
    levels) of phase 12's first forecast file, called as users call it (it
    builds its SHT: the tables on the card): the whole call in s with the
    set-up's share, the host memory it took, the tables' device bytes and
    the device peak; then ms per call with the tables prebuilt
    (ops.sht.SHT pointed at the built instance for the timing); spectra
    finite. A round trip of a field band-limited to l < SHT_BAND on 721
    Gauss latitudes within SHT_ROUNDTRIP_TOL (the equiangular grid's
    reading printed beside it); at 181x360 the tables built on the card
    bitwise equal to the host's on both grids, and the spectra of the
    winds sampled to 181x360 on the card against the CPU within
    SHT_SPECTRA_TOL of each spectrum's largest degree."""
    import numpy as np

    from credit_torch import metrics
    from credit_torch.grid import Grid
    from credit_torch.ops import sht as sht_mod
    from credit_torch.tools import cuda_ms
    from credit_torch.utils.ncio import open_dataset

    h, w = CONF_025["image_height"], CONF_025["image_width"]
    ds = open_dataset(forecast)
    u, v = (torch.from_numpy(np.asarray(ds[k].values, np.float32)[0]).cuda() for k in ("U", "V"))
    grid = Grid.regular(h, w)
    g = torch.Generator(device="cuda").manual_seed(14)
    real_sht = sht_mod.SHT

    def band_limited(sht):
        c = torch.randn((sht.lmax, sht.mmax, 2), generator=g, device="cuda")
        flm = torch.view_as_complex(c)
        l, m = torch.arange(sht.lmax, device="cuda")[:, None], sht.m[None, :]
        flm = torch.where((l < SHT_BAND) & (m <= l), flm, torch.zeros_like(flm))
        flm[:, 0] = flm[:, 0].real
        return flm

    def round_trip(sht):
        f = sht.spec2grid(band_limited(sht))
        return float((sht.spec2grid(sht.grid2spec(f)) - f).abs().max() / f.abs().max())

    def timed_sht(*args, **kwargs):
        t0 = time.time()
        sht = real_sht(*args, **kwargs)
        torch.cuda.synchronize()
        built.append((sht, time.time() - t0))
        return sht

    for name, lat, kind in (("equiangular", grid.lat, "equiangular"),
                            ("legendre-gauss", np.rad2deg(np.arcsin(
                                np.polynomial.legendre.leggauss(h)[0])), "legendre-gauss")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        built = []
        with HostPeak() as host:
            t0 = time.time()
            if kind == "equiangular":
                sht_mod.SHT = timed_sht
                try:
                    rot, div = metrics.divergent_rotational_spectra(u, v, grid)
                finally:
                    sht_mod.SHT = real_sht
            else:
                timed_sht(lat, w, grid=kind, device="cuda")
            torch.cuda.synchronize()
            whole = time.time() - t0
        (sht, setup), = built
        tables = sum(t.numel() * t.element_size() for t in (sht.pct, sht.pw, sht.dpct, sht.w))
        log(f"  SHT {name} {h}x{w} (lmax {sht.lmax}, mmax {sht.mmax}): set-up {setup:.1f} s "
            f"(tables built on the card), host memory +{host.bytes / 2**30:.2f} GiB "
            f"at its peak, tables {tables} bytes ({tables / 2**30:.2f} GiB) on the card")
        if kind == "equiangular":
            sht_mod.SHT = lambda *args, **kwargs: sht
            try:
                ms = cuda_ms(lambda: metrics.divergent_rotational_spectra(u, v, grid), 5)
            finally:
                sht_mod.SHT = real_sht
            dev_peak = torch.cuda.max_memory_allocated()
            finite = bool(torch.isfinite(rot).all() and torch.isfinite(div).all())
            log(f"  divergent_rotational_spectra of U, V {tuple(u.shape)}: {whole:.1f} s a call "
                f"as users make it (set-up {setup:.1f} s of it), {ms:.2f} ms a call with the "
                f"tables prebuilt, device peak {dev_peak} bytes ({dev_peak / 2**30:.2f} GiB); "
                f"spectra {tuple(rot.shape)} finite {finite}; rotational KE at l = 1, 10, 100: "
                f"{[float(rot[0, k]) for k in (1, 10, 100) if k < h]}")
            if not finite or tuple(rot.shape) != (13, h):
                raise AssertionError("the 0.25-degree spectra are not finite")
            log(f"  round trip, l < {SHT_BAND}, equiangular (approximate quadrature; printed, "
                f"not held): {round_trip(sht):.3e} of max|f|")
        else:
            err = round_trip(sht)
            log(f"  round trip, l < {SHT_BAND}, legendre-gauss: {err:.3e} of max|f|, limit "
                f"{SHT_ROUNDTRIP_TOL:g}")
            if not err <= SHT_ROUNDTRIP_TOL:
                raise AssertionError("the SHT round trip at 721x1440 failed")
        del sht, built
        torch.cuda.empty_cache()
    us, vs = u[:, ::4, ::4].contiguous(), v[:, ::4, ::4].contiguous()
    small = Grid.regular(*us.shape[-2:])
    same = {}
    for kind, lat in (("equiangular", small.lat), ("legendre-gauss", np.rad2deg(np.arcsin(
            np.polynomial.legendre.leggauss(small.nlat)[0])))):
        card, host = (real_sht(np.asarray(lat), small.nlon, grid=kind, device=d)
                      for d in ("cuda", "cpu"))
        same[kind] = all(torch.equal(getattr(card, t).cpu(), getattr(host, t))
                         for t in ("pct", "pw", "dpct"))
    log(f"  tables at {small.nlat}x{small.nlon} built on the card equal the host's bitwise: "
        f"{same}")
    if not all(same.values()):
        raise AssertionError("the SHT's tables built on the card differ from the host's")
    card = metrics.divergent_rotational_spectra(us, vs, small)
    cpu = metrics.divergent_rotational_spectra(us.cpu(), vs.cpu(), small)
    err = max(float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in zip(card, cpu))
    log(f"  spectra at {small.nlat}x{small.nlon} (U, V every 4th point), card vs CPU: {err:.3e} of the largest "
        f"degree, limit {SHT_SPECTRA_TOL:g}")
    if not err <= SHT_SPECTRA_TOL:
        raise AssertionError("the spectra on the card disagree with the CPU")


def granule_phase() -> None:
    """Two granules each of GOES ABI CONUS, HRRR and MRMS at their real sizes
    (the port's netCDF writer, seeded values), then one sample (inputs at
    the first time, targets at the second: both granules) of each source
    read through build_multi_source, the multi-source dispatch, on the
    host: ms and MB of each."""
    import datetime as dt
    import numpy as np

    from credit_torch.data.channels import ChannelSchema
    from credit_torch.data.multi_source import build_multi_source
    from credit_torch.utils.ncio import Dataset, Variable

    root = os.path.join(HERE, "build", "granules")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(15)
    ny, nx = GOES_SHAPE
    goes_coords = {"x": GOES_X0 + GOES_STEP * np.arange(nx), "y": GOES_Y0 - GOES_STEP * np.arange(ny)}
    projection = Variable((), np.zeros(()), {
        "longitude_of_projection_origin": -75.0, "perspective_point_height": 35786023.0,
        "semi_major_axis": 6378137.0, "semi_minor_axis": 6356752.31414})
    my, mx = MRMS_SHAPE
    mrms_coords = {"lat": 54.995 - 0.01 * np.arange(my), "lon": 230.005 + 0.01 * np.arange(mx)}

    def goes(t):
        doy = t.timetuple().tm_yday
        name = f"OR_ABI-L2-MCMIPC-M6_G16_s{t.year}{doy:03d}{t:%H%M%S}2_e0_c0.nc"
        return name, Dataset({**{f"CMI_C{b:02d}": (("y", "x"), rng.uniform(
            200, 300, GOES_SHAPE).astype(np.float32)) for b in (2, 7, 13)},
            "goes_imager_projection": projection}, coords=goes_coords)

    def hrrr(t):
        shape = (len(HRRR_LEVELS), *HRRR_SHAPE)
        return f"HRRR_{t:%Y%m%d-%H%M%S}.nc", Dataset({
            "T": (("level", "y", "x"), rng.uniform(220, 300, shape).astype(np.float32)),
            "U": (("level", "y", "x"), rng.normal(0, 10, shape).astype(np.float32))},
            coords={"level": np.asarray(HRRR_LEVELS)})

    def mrms(t):
        return f"MRMS_{t:%Y%m%d-%H%M%S}.nc", Dataset({"MultiSensor_QPE_01H_Pass2": (
            ("lat", "lon"), rng.exponential(1.0, MRMS_SHAPE).astype(np.float32))},
            coords=mrms_coords)

    cases = [
        ("GOES", goes, dt.datetime(2021, 6, 1), dt.timedelta(hours=6), dt.timedelta(minutes=1),
         {"dataset_type": "goes", "variables": {"prognostic": {"vars_2D": [
             "CMI_C02", "CMI_C07", "CMI_C13"]}}}),
        ("HRRR", hrrr, dt.datetime(2022, 3, 1), dt.timedelta(hours=6), dt.timedelta(0),
         {"dataset_type": "hrrr", "levels": HRRR_LEVELS,
          "variables": {"prognostic": {"vars_3D": ["T", "U"]}}}),
        ("MRMS", mrms, dt.datetime(2024, 6, 1), dt.timedelta(hours=1), dt.timedelta(0),
         {"dataset_type": "mrms", "variables": {"prognostic": {"vars_2D": [
             "MultiSensor_QPE_01H_Pass2"]}}})]
    try:
        for name, make, t0, step, offset, src in cases:
            path = os.path.join(root, name)
            os.makedirs(path)
            w0 = time.perf_counter()
            for k in range(2):
                fname, ds = make(t0 + k * step + offset)
                ds.to_netcdf(os.path.join(path, fname))
            size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
            write = time.perf_counter() - w0
            conf = {"data": {"source": {name: {**src, "mode": "local", "path": path}},
                             "start_datetime": f"{t0:%Y-%m-%d %H:%M}",
                             "end_datetime": f"{t0 + step:%Y-%m-%d %H:%M}",
                             "timestep": f"{int(step.total_seconds()) // 60}min"}}
            r0 = time.perf_counter()
            ds = build_multi_source(conf, ChannelSchema.from_config(conf), None)
            sample = ds.sample(0, 1)
            ms = (time.perf_counter() - r0) * 1e3
            nbytes = sum(a.nbytes for a in sample.values() if a is not None)
            ok = all(np.isfinite(a).all() for a in sample.values() if a is not None)
            log(f"  {name}: 2 granules, {size} bytes written in {write:.1f} s; one sample "
                f"(x {sample['x'].shape}, y {sample['y'].shape}) read in {ms:.0f} ms on the host, "
                f"{nbytes / 1e6:.1f} MB; finite {ok}")
            if not ok or sample["x"].shape[-1] != len(ds.schema.input_names):
                raise AssertionError(f"the {name} granules read wrong")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def skebs_net_launches(want: dict, backward: bool) -> dict:
    """A path's launches per step with the learned backscatter rate: the
    cnn's 3x3 conv adds a kernel 2 launch a forward and, in training, a
    kernel 5 launch (its input is the batch: no input gradient)."""
    out = dict(want)
    out["conv2d_valid"] = out.get("conv2d_valid", 0) + 1
    if backward:
        out["conv2d_wgrad"] = out.get("conv2d_wgrad", 0) + 1
    return out


def hybrid_setup(shape, seed: int):
    """14 seeded monotone hybrid interfaces for 13 levels (a rising from 0,
    b from 0 to 1) and a seeded surface geopotential of `shape`, as the
    forecast's fixers take them (forecast_setup)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ak = np.concatenate([[0.0], np.sort(rng.uniform(0.0, 2e4, 13))])
    bk = np.concatenate([[0.0], np.sort(rng.uniform(0.0, 1.0, 12)), [1.0]])
    return ak, bk, rng.uniform(0.0, 3e4, shape).astype(np.float32)


def skebs_fit_path(torch, store_info, want_train: dict, want_valid: dict, model: dict = None,
                   device: str = "cuda"):
    """Main path 11 (a), the SKEBS ensemble trained: run_training
    (prepare_training + fit) of CONF_025_ENS with SKEBS_POST on main path
    7's store for one epoch of SKEBS_TRAINER. Checks: the log finite; the
    SKEBS block's first call changing every U and V channel and leaving
    every other channel bitwise equal; the net's weights moved by the
    first step and held, as they end, by the state, the EMA and the
    checkpoint under `_postblocks.2.` (Denorm 0, the tracer fixer 1, SKEBS
    2); the launches (2 steps of 2 members and a 2-member validation
    batch, the net's conv included). Prints the SHT's set-up, the step,
    validation and assembly times and the peak memory. Returns the launch
    counts and the config."""
    from credit_torch.applications import prepare_training
    from credit_torch.physics import skebs as skebs_mod
    from credit_torch.postblock import stochastic
    from credit_torch.trainers.trainer import Trainer

    store, stats, data, _ = store_info
    root = os.path.dirname(store)
    conf = fit_conf({**(model or CONF_025_ENS), "post_conf": SKEBS_POST}, data, store, stats,
                    os.path.join(root, "skebs"), SKEBS_TRAINER, *FIT_WINDOWS)
    conf["loss"] = ENS_LOSS
    sht_s, first = [], {}
    init, call = skebs_mod.SKEBS.__init__, stochastic.SKEBSPostblock.__call__

    def timed_init(self, *args, **kw):
        t1 = time.time()
        init(self, *args, **kw)
        sht_s.append(time.time() - t1)

    def watched_call(self, y, x, state, generator=None, net_params=None):
        out = call(self, y, x, state, generator, net_params)
        if not first:  # the first call: which channels it changed
            with torch.no_grad():
                moved = (out[0] != y).flatten(0, -2).any(0).cpu().tolist()
            first["moved"] = {n for n, m in zip(schema.target_names, moved) if m}
        return out

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    skebs_mod.SKEBS.__init__, stochastic.SKEBSPostblock.__call__ = timed_init, watched_call
    try:
        t0 = time.time()
        trainer, state, start, seed = prepare_training(conf, device=device)
        schema = trainer.schema
        log(f"  set-up (data, crossformer-ensemble model, trainer, postblocks {[type(b).__name__ for b in trainer.train_postblocks]}): "
            f"{time.time() - t0:.1f} s, of which SKEBS's SHT (lmax "
            f"{trainer.train_postblocks[2].skebs.sht.lmax}, mmax "
            f"{trainer.train_postblocks[2].skebs.sht.mmax}; tables built on the host) "
            f"{sum(sht_s):.1f} s")
        step, moved_net = trainer._train_step_for(1), []

        def watched(state, batch):
            net = list(state.nets.parameters())
            before = [p.detach().to("cpu", copy=True) for p in net] if not moved_net else None
            out = step(state, batch)
            if before is not None:
                moved_net.append(not all(torch.equal(p.detach().cpu(), b)
                                         for p, b in zip(net, before)))
            return out

        trainer._step_cache[1] = watched
        t1 = time.time()
        state = trainer.fit(state, seed=seed, start_epoch=start)
        torch.cuda.synchronize()
    finally:
        skebs_mod.SKEBS.__init__, stochastic.SKEBSPostblock.__call__ = init, call
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  run_training 1 epoch: {time.time() - t0:.1f} s end to end ({time.time() - t1:.1f} s "
        f"in fit), peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB), launches {counts}")
    fit_times(trainer)
    winds = {n for n in schema.target_names if n.rpartition("_L")[0] in ("U", "V")}
    names = [f"_postblocks.2.conv.{k}" for k in ("kernel", "bias")]
    saved = torch.load(os.path.join(conf["save_loc"], "checkpoint", Trainer.CHECKPOINT_FILE),
                       map_location="cpu", weights_only=True)
    live = state.named_parameters()
    held = all(torch.equal(saved["model"][k], live[k].detach().cpu())
               and torch.equal(saved["ema_params"][k], state.ema_params[k].cpu())
               for k in names)
    log(f"  SKEBS's first call changed {len(first['moved'])} channels, U and V's "
        f"{len(winds)} exactly: {first['moved'] == winds}; the net's weights moved by the "
        f"first step: {moved_net}; {names} in the optimizer "
        f"({all(k in state.opt_state['mu'] for k in names)}), the EMA and the checkpoint "
        f"(model and EMA, equal to the state's: {held})")
    rows = read_log(conf["save_loc"])
    cells = [float(c) for r in rows[1:] for c in r[1:]]
    log(f"  training_log.csv: {len(rows) - 1} row, {len(rows[0])} columns, (train, valid) loss "
        f"{[(float(r[1]), float(r[2])) for r in rows[1:]]}")
    if (first["moved"] != winds or moved_net != [True] or not held or len(rows) != 2
            or not all(math.isfinite(v) for v in cells) or state.step != 2):
        raise AssertionError("the CONF_025 SKEBS ensemble fit failed its checks")
    _check_counts(counts, {k: 2 * want_train.get(k, 0) + want_valid.get(k, 0) for k in counts}, 1)
    del state, trainer, step, saved, live
    return counts, conf


def skebs_rollout_path(torch, store_info, fit: dict, want: dict, device: str = "cuda"):
    """Main path 11 (b): run_rollout from (a)'s checkpoint (its EMA, the
    net's included) over the store's clock, 1 init time of SKEBS_STEPS
    steps, ensemble 1, with SKEBS writing its debug files and, after it,
    semi-Lagrangian advection of Q (14 seeded hybrid interfaces), the wind
    filter and the MSLP diagnostic into d0 (T from VAR_2T, a seeded surface
    geopotential). Checks: SKEBS_STEPS forecast files and as many
    debug_skebs/skebs_NNNN.nc, finite; consecutive steps' psi_pattern
    correlated at least SKEBS_CORR (the state carried); advected Q within
    [min, max] of Q before the block (trilinear weights are convex; f32
    rounding allowed: 1e-6 of max |Q|); no level's largest wind speed raised
    by the wind filter (a convex blend of the winds and their smoothing;
    the same 1e-6), which blends at least WIND_SHARE of the points (its
    blend weight > 0, from the mask level's speeds) on every step; the
    launches. Prints the wall ms/step with the writes,
    copy ms and peak memory. Returns the launch counts and the rollout's
    last state: (config, the last prediction and the next input, physical,
    on the card)."""
    import numpy as np

    from credit_torch import rollout
    from credit_torch.applications import run_rollout
    from credit_torch.postblock import stochastic, wind_filter
    from credit_torch.utils.ncio import open_dataset

    store, stats, data, _ = store_info
    root = os.path.dirname(store)
    out, debug = os.path.join(root, "skebs_forecasts"), os.path.join(root, "skebs_debug")
    h, w = fit["model"]["image_height"], fit["model"]["image_width"]
    ak, bk, gph = hybrid_setup((h, w), 14)
    post = {**SKEBS_POST,
            "skebs": {**SKEBS_POST["skebs"], "write_rollout_debug_files": True, "save_loc": debug},
            "semilagrangian_advection": {"activate": True, "a_half": ak, "b_half": bk,
                                         "tracer_vars": ["Q"]},
            "wind_artifact_filter": {"activate": True, "speed_threshold": WIND_THRESHOLD},
            "mslp_diagnostic": {"activate": True, "output_name": "d0",
                                "temperature_var": "VAR_2T", "surface_geopotential": gph}}
    conf = fit_conf({**fit["model"], "post_conf": post}, data, store, stats, fit["save_loc"],
                    SKEBS_TRAINER, NC_WINDOW, FIT_WINDOWS[1])
    conf["loss"] = ENS_LOSS
    conf["predict"] = {"forecasts": {"start_year": 1979, "start_month": 1, "start_day": 1,
                                     "start_hours": [0], "duration": 1},
                       "forecast_steps": SKEBS_STEPS, "save_forecast": out}
    checks = {"q": [], "speed": [], "blended": [], "peak": []}
    adv_call = stochastic.AdvectionPostblock.__call__
    wf_call = wind_filter.WindArtifactFilter.__call__
    step, run = rollout.RolloutEngine.step, rollout.RolloutEngine.run
    runs, last = [], {}

    def watched_adv(self, y, x):
        new = adv_call(self, y, x)
        q0, q1 = self.tracers[0].get(y), self.tracers[0].get(new)
        checks["q"].append(torch.stack([q0.min(), q0.max(), q1.min(), q1.max(),
                                        q0.abs().max()]).cpu())
        return new

    def watched_wf(self, y, x):
        new = wf_call(self, y, x)
        speed = [torch.sqrt(self.U.get(a) ** 2 + self.V.get(a) ** 2) for a in (y, new)]
        checks["speed"].append(torch.stack([s.flatten(0, -2).amax(0) for s in speed]).cpu())
        um, vm = (view.get(y)[..., self.mask_level] for view in (self.U, self.V))
        blend = wind_filter.compute_blend_mask(um, vm, self.speed_threshold, self.dz, self.dm,
                                               self.falloff_sigma)
        checks["peak"].append(float(speed[0][..., self.mask_level].max()))
        checks["blended"].append(float((blend > 0).float().mean()))
        return new

    def watched_step(self, x, forcing_next=None):
        y, x_next = step(self, x, forcing_next)
        last.update(y=y, x=x_next, normalizer=self.normalizer)
        return y, x_next

    def timed_run(self, *args, **kw):
        t1 = time.perf_counter()
        res = run(self, *args, **kw)
        runs.append(((time.perf_counter() - t1) * 1e3, list(self.copy_ms)))
        return res

    shutil.rmtree(debug, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    stochastic.AdvectionPostblock.__call__ = watched_adv
    wind_filter.WindArtifactFilter.__call__ = watched_wf
    rollout.RolloutEngine.step, rollout.RolloutEngine.run = watched_step, timed_run
    try:
        t0 = time.time()
        paths = run_rollout(conf, use_ema=True, device=device)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    finally:
        stochastic.AdvectionPostblock.__call__ = adv_call
        wind_filter.WindArtifactFilter.__call__ = wf_call
        rollout.RolloutEngine.step, rollout.RolloutEngine.run = step, run
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    (ms, copies), = runs
    log(f"  run_rollout (use_ema) 1 init x {SKEBS_STEPS} steps: {wall:.0f} ms end to end, of "
        f"which set-up (data, trainer with its SKEBS, checkpoint, fold) {wall - ms:.0f} ms; "
        f"{ms / SKEBS_STEPS:.1f} ms/step with the writes and the debug files; copy ms "
        f"{[round(v, 2) for v in copies]}; peak memory {peak} bytes ({peak / 2**30:.2f} GiB); "
        f"launches {counts}")
    _check_counts(counts, want, SKEBS_STEPS)
    files = sorted(os.listdir(os.path.join(debug, "debug_skebs")))
    finite = all(np.isfinite(np.asarray(open_dataset(p)[k].values)).all()
                 for p in paths for k in ("U", "V", "Q", "d0"))
    fields = {k: [] for k in ("psi_pattern", "pert_u", "pert_v")}
    for f in files:
        ds = open_dataset(os.path.join(debug, "debug_skebs", f))
        for k in fields:
            fields[k].append(np.asarray(ds[k].values, np.float64).ravel())
    finite = finite and all(np.isfinite(a).all() for v in fields.values() for a in v)
    corr = {k: [float(np.corrcoef(a, b)[0, 1]) for a, b in zip(v, v[1:])]
            for k, v in fields.items()}
    q = torch.stack(checks["q"]).double()
    q_ok = bool(((q[:, 2] >= q[:, 0] - 1e-6 * q[:, 4]) & (q[:, 3] <= q[:, 1] + 1e-6 * q[:, 4])).all())
    sp = torch.stack(checks["speed"]).double()  # (steps, before/after, levels)
    sp_ok = bool((sp[:, 1] <= sp[:, 0] * (1 + 1e-6)).all())
    wf_ok = min(checks["blended"]) >= WIND_SHARE
    log(f"  {len(paths)} forecast files and debug_skebs/ {files}, finite: {finite}; "
        f"consecutive steps' correlation: psi_pattern {[round(c, 4) for c in corr['psi_pattern']]} "
        f"(limit {SKEBS_CORR}), pert_u {[round(c, 4) for c in corr['pert_u']]}, pert_v "
        f"{[round(c, 4) for c in corr['pert_v']]}")
    log(f"  advected Q within the range of Q before the block at every step: {q_ok} "
        f"(before/after min, max per step: {[[float(f'{v:.4e}') for v in row[:4]] for row in q]}); "
        f"the wind filter (threshold {WIND_THRESHOLD:g} m/s; the mask level's peak speed "
        f"{[round(v, 3) for v in checks['peak']]}) blended {[round(b, 4) for b in checks['blended']]} "
        f"of the points (limit {WIND_SHARE:g} each step) and raised no level's largest speed: "
        f"{sp_ok} (largest speed over the levels before, after: "
        f"{[[round(float(a), 3), round(float(b), 3)] for a, b in zip(sp[:, 0].amax(1), sp[:, 1].amax(1))]})")
    if (len(paths) != SKEBS_STEPS or files != [f"skebs_{s:04d}.nc" for s in range(SKEBS_STEPS)]
            or not finite or min(corr["psi_pattern"]) < SKEBS_CORR or not q_ok or not sp_ok
            or not wf_ok):
        raise AssertionError("the SKEBS rollout failed its checks")
    norm = last["normalizer"]
    state = (conf, norm.denormalize_target(last["y"]).float(),
             norm.denormalize_input(last["x"]).float())
    return counts, state


def physics_phase(torch, state) -> None:
    """Main path 11 (c): the physics blocks on the SKEBS rollout's last state
    (the prediction and the input it makes): ms a call on the card at full
    size (CUDA events, after a warm-up call), and on the same state
    subsampled to PHYS_CHECK_GRID (every 4th row and column) the port on
    the CPU (host clock) against the card, for each variable a block writes,
    level by level (relative to that level's largest |CPU value|), with
    every other channel bitwise equal to the block's input on the card:
    DiffusionPoleFilter.filter_winds (U, V) and filter_scalar (T) on 13
    levels (its SHT built on the host: set-up s printed; POLE_TOL), the
    postblocks pressure_interp_diagnostic (T onto the 13 store levels,
    written into U's block), geopotential_diagnostic (into V's block),
    hybrid_level_interp (T and Q onto other levels) and
    wind_artifact_filter (U, V), the preblocks hybrid_level_interp and
    semilagrangian_advection (Q) (PHYS_TOL; the interpolations in log p
    within LOGP_ROUND's bound; for advection its departure points no
    farther from the CPU's f64 ones than the CPU's f32 ones, by DEP_FACTOR
    and DEP_TOL, and the advected Q within the bound the card's and the
    CPU's points' distance gives)."""
    from credit_torch.tools import cuda_ms

    conf, y, x = state
    h, w = PHYS_CHECK_GRID
    step = (y.shape[2] - 1) // (h - 1)
    small = ({**conf, "model": {**conf["model"], "image_height": h, "image_width": w}},
             y[:, :, ::step, ::step].contiguous(), x[:, :, ::step, ::step].contiguous())
    full_size = f"{y.shape[2]}x{y.shape[3]}"
    for full, check in zip(physics_cases(torch, *state), physics_cases(torch, *small)):
        name, fn, args, writes, tol, judge, (lev, chans, level_errs) = check
        # the CPU first: the pole filter's tables are built there, and each
        # block moves its tables to its input's device at the call
        cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
        t1 = time.perf_counter()
        ref = fn(*cpu_args)
        cpu_ms = (time.perf_counter() - t1) * 1e3
        out = fn(*args)
        # the warm-up moves the full-size tables to the card; its output is
        # held: finite where the block writes, the rest as it came in
        big = full[1](*full[2])
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: full[1](*full[2]), 3)
        if writes is None:
            outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            pairs = {f"out{i}": (o, r) for i, (o, r) in enumerate(zip(outs, refs))}
            rest = big_rest = True
            big_finite = all(bool(torch.isfinite(o).all())
                             for o in (big if isinstance(big, tuple) else (big,)))
        else:
            pairs = {v: (lev(out, v, t), lev(ref, v, t)) for v, t in writes}
            written = {c for v, t in writes for c in chans(v, t)}
            others = [c for c in range(out.shape[-1]) if c not in written]
            rest = torch.equal(out[..., others], args[0][..., others])
            big_rest = torch.equal(big[..., others], full[2][0][..., others])
            big_finite = all(bool(torch.isfinite(lev(big, v, t)).all()) for v, t in writes)
        del big
        errs = {k: level_errs(o, r) for k, (o, r) in pairs.items()}
        ok = rest and big_rest and big_finite and (
            all(float(e.max()) <= tol for e in errs.values()) if judge is None
            else judge(out, ref, args, cpu_args))
        log(f"  {name}: {ms:.2f} ms a call on the card at {full_size}; at {h}x{w} {cpu_ms:.0f} "
            "ms on the CPU, card vs CPU, the worst level's largest |difference| over its "
            "largest |CPU value|: "
            + ", ".join(f"{k} {float(e.max()):.2e}" for k, e in errs.items())
            + (f" (limit {tol:g})" if judge is None else "")
            + ("" if writes is None else f"; the other {len(others)} channels as they came in: "
               f"{rest}")
            + f"; at {full_size} on the card: finite {big_finite}"
            + ("" if writes is None else f", the other channels as they came in {big_rest}"))
        if not ok:
            raise AssertionError(f"{name} on the card disagrees with the CPU or is not finite "
                                 f"at {full_size}")
        del full, check, fn, args, cpu_args, out, ref
        torch.cuda.empty_cache()


def physics_cases(torch, conf, y, x):
    """physics_phase's blocks on one state, one at a time (the pole filter's
    tables live while its two cases run): (name, block, args, the variables
    it writes (None: a function of tensors), tolerance, check or None,
    (lev, chans, level_errs))."""
    import numpy as np

    from credit_torch import registry
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.grid import grid_from_conf
    from credit_torch.physics.pole_filter import DiffusionPoleFilter
    from credit_torch.postblock import wind_filter

    schema, grid = ChannelSchema.from_config(conf), grid_from_conf(conf)
    full = lambda a: 0.5 * (a[:-1] + a[1:])  # noqa: E731
    ak, bk, gph = hybrid_setup(grid.shape, 14)  # the rollout's
    a2, b2, _ = hybrid_setup(grid.shape, 15)
    plevs = [100.0 * p for p in FIT_LEVELS]

    def chans(name, target=True):
        names = schema.target_names if target else schema.input_names
        return [i for i, n in enumerate(names) if n == name or n.rpartition("_L")[0] == name]

    def lev(flat, name, target=True):
        """(levels, H, W) of a variable of a (1, 1, H, W, C) tensor."""
        return flat[0, 0][..., chans(name, target)].movedim(-1, 0).contiguous()

    def level_errs(got, want):
        """Each level's largest |card - CPU| over its largest |CPU|."""
        o, r = got.double().cpu().flatten(1), want.double().cpu().flatten(1)
        return (o - r).abs().amax(1) / r.abs().amax(1).clamp_min(1e-30)

    views = (lev, chans, level_errs)

    t0 = time.time()
    with HostPeak() as host:
        pf = DiffusionPoleFilter(grid)
    log(f"  DiffusionPoleFilter {grid.nlat}x{grid.nlon}: its SHT set up in {time.time() - t0:.1f} s "
        f"(host +{host.bytes / 2**30:.2f} GiB)")
    u, v, t = lev(y, "U"), lev(y, "V"), lev(y, "T")
    yield ("filter_winds (U, V, 13 levels)", pf.filter_winds, (u, v), None, POLE_TOL, None,
           views)
    yield ("filter_scalar (T, 13 levels)", pf.filter_scalar, (t,), None, POLE_TOL, None, views)
    del pf, u, v, t

    def block(key, **kw):
        return registry.get("postblock", key)(schema=schema, grid=grid, **kw)

    def level_pressures(a_lev, b_lev, target=True, half=False):
        """A tensor's source-level pressures (H, W, L) in f64, as a block
        makes them: a + b SP on the levels, or on interfaces clamped at the
        model top and then their means (half=True)."""
        def pressures(a):
            sp = lev(a, "SP", target)[0].double().cpu()[..., None]
            p = torch.as_tensor(a_lev) + torch.as_tensor(b_lev) * sp
            if not half:
                return p
            p = torch.where(p > 0, p, torch.full_like(p, 0.57))
            return 0.5 * (p[..., :-1] + p[..., 1:])
        return pressures

    def interp_check(sources, pressures):
        """sources: {written variable: (source variable, target?)}. Each
        written level within its column's steepest |jump of the source| per
        unit of log p (over its thinnest layer) times LOGP_ROUND, plus
        PHYS_TOL of the level's largest |CPU value|."""
        def check(out, ref, args, cpu_args):
            logp = torch.log(pressures(cpu_args[0]))
            ok, worst = True, []
            for v, (src, target) in sources.items():
                ys = lev(cpu_args[0], src, target).double().movedim(0, -1)
                slope = ys.diff(dim=-1).abs().amax(-1) / logp.diff(dim=-1).abs().amin(-1)
                got, want = lev(out, v, target).double().cpu(), lev(ref, v, target).double()
                diff = (got - want).abs()
                scale = want.flatten(1).abs().amax(1)[:, None, None]
                bound = slope * LOGP_ROUND + PHYS_TOL * scale
                ok = ok and bool((diff <= bound).all())
                worst.append(f"{v} {float((diff / bound).max()):.3f}")
            log(f"    largest |card - CPU| over its bound: {', '.join(worst)} (limit 1)")
            return ok
        return check

    posts = [
        ("pressure_interp_diagnostic (T onto 13 pressure levels)", [("U", True)], block(
            "pressure_interp_diagnostic", input_var="T", output_var="U", pressure_levels=plevs,
            a_half=ak, b_half=bk),
         interp_check({"U": ("T", True)}, level_pressures(ak, bk, half=True))),
        ("geopotential_diagnostic", [("V", True)], block(
            "geopotential_diagnostic", a_half=ak, b_half=bk, surface_geopotential=gph,
            output_name="V"), None),
        ("hybrid_level_interp postblock (T, Q)", [("T", True), ("Q", True)], block(
            "hybrid_level_interp", variables=["T", "Q"], a_in=full(ak), b_in=full(bk),
            a_out=full(a2), b_out=full(b2)),
         interp_check({"T": ("T", True), "Q": ("Q", True)}, level_pressures(full(ak), full(bk))))]
    for name, writes, b, check in posts:
        yield name, b, (y, x), writes, PHYS_TOL, check, views
    del posts

    # the state has passed the rollout's own filter: the threshold here is
    # the mask level's 99th percentile of speed, so that the filter blends
    # a share of the grid around the fastest 1%
    probe = block("wind_artifact_filter")
    mask_speed = torch.sqrt(probe.U.get(y)[..., probe.mask_level] ** 2
                            + probe.V.get(y)[..., probe.mask_level] ** 2)
    wf = block("wind_artifact_filter",
               speed_threshold=float(torch.quantile(mask_speed.flatten().cpu(), 0.99)))

    def blends(a):
        um, vm = (view.get(a)[..., wf.mask_level] for view in (wf.U, wf.V))
        return (torch.sqrt(um**2 + vm**2) > wf.speed_threshold,
                wind_filter.compute_blend_mask(um, vm, wf.speed_threshold, wf.dz, wf.dm,
                                               wf.falloff_sigma))

    def wind_check(out, ref, args, cpu_args):
        # a speed within rounding of the threshold may fall on either side
        # of it on the two sides: those points' dilated neighbourhoods
        # (where the two blend weights differ by more than rounding) are
        # left out, and the points themselves must lie within 1e-5 of the
        # threshold
        (m_card, b_card), (m_cpu, b_cpu) = blends(args[0]), blends(cpu_args[0])
        flip = (m_card.cpu() != m_cpu)
        speed = torch.sqrt(wf.U.get(cpu_args[0])[..., wf.mask_level] ** 2
                           + wf.V.get(cpu_args[0])[..., wf.mask_level] ** 2)
        near = ((speed - wf.speed_threshold).abs() <= 1e-5 * wf.speed_threshold)
        same = ((b_card.cpu() - b_cpu).abs() <= 1e-6)[0, 0]
        worst = max(float(level_errs(lev(out, k).cpu()[:, same], lev(ref, k)[:, same]).max())
                    for k in ("U", "V"))
        share = float((b_cpu > 0).double().mean())
        log(f"    mask-level peak speed {float(speed.max()):.3f} m/s, threshold (its 99th "
            f"percentile) {wf.speed_threshold:.3f}: blended share {share:.4f}; mask points on "
            f"either side of the threshold {int(flip.sum())} (all within 1e-5 of it: "
            f"{bool((near | ~flip).all())}); points left out {int((~same).sum())}; worst level "
            f"over the rest {worst:.2e} (limit {PHYS_TOL:g})")
        return bool((near | ~flip).all()) and worst <= PHYS_TOL and share > 0

    yield ("wind_artifact_filter (U, V)", wf, (y, x), [("U", True), ("V", True)], PHYS_TOL,
           wind_check, views)
    pre = registry.get("preblock", "hybrid_level_interp")(
        schema=schema, variables=["T", "Q"], ak_in=ak, bk_in=bk, ak_out=a2, bk_out=b2)
    yield ("hybrid_level_interp preblock (T, Q)", pre, (x,), [("T", False), ("Q", False)],
           PHYS_TOL, interp_check({"T": ("T", False), "Q": ("Q", False)},
                                  level_pressures(ak, bk, False, half=True)), views)
    adv = registry.get("preblock", "semilagrangian_advection")(
        schema=schema, grid=grid, a_half=ak, b_half=bk, tracer_vars=["Q"])

    def departure_check(out, ref, args, cpu_args):
        # the departure points themselves, as the sampler takes them (rows
        # and levels clamped to the volume, columns floor-mod on the
        # circle), the card's and the CPU's (f32) each against the CPU's in
        # f64 from the same inputs: in every band of rows and on each axis
        # the card's largest distance from f64 within DEP_FACTOR times the
        # CPU's plus DEP_TOL cells. Near the poles they are ill-conditioned
        # (a row by the pole moves by ~1e3-1e5 columns, whose f32 rounding
        # the midpoint iterations amplify), and there both sides are far
        # from f64. Then the advected Q: trilinear sampling moves by at
        # most the largest neighbour difference along an axis per unit of
        # that axis, so card and CPU lie within that times their points'
        # distance plus PHYS_TOL of the level's largest |Q|
        def deps(a):
            h, w = a.shape[2:4]
            flat = lambda view: view.get(a).reshape(-1, h, w, 13)  # noqa: E731
            r, c, l = adv.engine.departure_indices(flat(adv.U), flat(adv.V),
                                                   adv.sp.get(a).reshape(-1, h, w))
            return (r.clamp(0, h - 1).double().cpu()[0], torch.remainder(c, w).double().cpu()[0],
                    l.clamp(0, 12).double().cpu()[0])

        def dist(p, q):
            d = [(a - b).abs() for a, b in zip(p, q)]
            w = p[1].shape[1]
            d[1] = torch.minimum(d[1], w - d[1])
            return d

        card, cpu, exact = deps(args[0]), deps(cpu_args[0]), deps(cpu_args[0].double())
        apart, card_err, cpu_err = dist(card, cpu), dist(card, exact), dist(cpu, exact)
        rows = card[0].shape[0]
        edges = sorted({min(max(e, 0), rows) for e in (0, 1, 5, 20, rows - 20, rows - 5,
                                                         rows - 1, rows)})
        ok, lines = True, []
        for a, b in zip(edges, edges[1:]):
            cells = []
            for axis, ce, pe, d in zip("rcl", card_err, cpu_err, apart):
                ce, pe = float(ce[a:b].max()), float(pe[a:b].max())
                ok = ok and ce <= DEP_FACTOR * pe + DEP_TOL
                cells.append(f"{axis} {ce:.1e}/{pe:.1e}/{float(d[a:b].max()):.1e}")
            lines.append(f"{a}-{b - 1}: " + " ".join(cells))
        lat = torch.from_numpy(np.deg2rad(grid.lat).astype(np.float32))
        floored = (torch.cos(lat) < adv.engine.coslat_floor).nonzero().flatten().tolist()
        log("    departure points (row r, column c, level l; cells), largest distance card-f64 / "
            f"CPU-f64 / card-CPU by rows: {'; '.join(lines)}; the cos(lat) floor's rows "
            f"{floored}; within {DEP_FACTOR:g} x CPU-f64 + {DEP_TOL:g}: {ok}")
        q = lev(cpu_args[0], "Q", False).movedim(0, -1).double()
        lips = [float(q.diff(dim=d).abs().max()) for d in (0, 1, 2)]
        lips[1] = max(lips[1], float((q[:, 0] - q[:, -1]).abs().max()))
        bound = sum(k * d for k, d in zip(lips, apart)).movedim(-1, 0)
        got, want = lev(out, "Q", False).double().cpu(), lev(ref, "Q", False).double()
        scale = want.flatten(1).abs().amax(1)[:, None, None]
        diff = (got - want).abs()
        within = bool((diff <= bound + PHYS_TOL * scale).all())
        log(f"    advected Q within the bound of the points' distance: {within}; largest "
            f"|card - CPU| {float(diff.max()):.3e} (largest |Q| {float(scale.max()):.3e}); "
            "by rows "
            + ", ".join(f"{a}-{b - 1} {float(diff[:, a:b].max()):.2e}"
                        for a, b in zip(edges, edges[1:])))
        return ok and within

    yield ("semilagrangian_advection preblock (Q)", adv, (x,), [("Q", False)], PHYS_TOL,
           departure_check, views)


# main path 15 (phase 18): parallelism on the one card. (a) run_training
# through maybe_initialize over NCCL at world size 1; (b) two ranks sharing
# the card over gloo, domain 2 (lat slabs, explicit halo), one CONF_025_TRAIN
# step and one of its crossformer-ensemble against the unsharded step; (c) the same two ranks at data 2 against
# the unsharded step on the batch of 2, and ring-CRPS at 2 members against
# the dense CRPS. Limits: bf16 compute on both sides, in other shapes (the
# kernels' plans, hence their f32 sums' orders, follow the shapes), each a
# few times what the card read (PERF.md, PR 16: the loss equal to 7 digits,
# the gradient 9.19e-4 and 7.28e-4 (ensemble) at domain 2 and 6.27e-4 at
# data 2, the halo benchmark's forward exact and its gradient 5.4e-3)
# the prediction's largest difference over its largest value, its mean
# difference over its mean value, and its worst latitude row's mean
# difference over its mean value (PERF.md, PR 16: CrossFormer /
# ensemble at domain 2 3.7e-3 / 6.9e-3, 2.3e-3 / 2.0e-3, 2.5e-3 / 2.2e-3;
# data 2 3.7e-3, 2.7e-4, 4.3e-4: one bf16 rounding of the largest values,
# and of most values at domain 2, whose group-norm moments sum in another
# order, spread evenly over the rows)
PAR_PRED_TOL = (2e-2, 7e-3, 7.5e-3)
PAR_LOSS_TOL = 1e-6  # relative
PAR_GRAD_TOL = 3e-3  # the gradient's difference over its norm
# CONF_FUXI's (PERF.md, §6): its bf16 step moves as much at data 2,
# where nothing is sharded but the batch (the unsharded step's GEMMs take
# twice the rows), as at domain 2 (gradient 6.45e-3 and 6.69e-3, the
# prediction 1.26e-2, 5.1e-3, 5.7e-3 at domain 2, the loss 1.1e-5); at
# data 2 the prediction is held against the unsharded forward of the
# rank's own rows, which ZeRO-3's gathered weights must give bitwise
PAR_FUXI_TOL = {"pred": (4e-2, 1.5e-2, 1.7e-2), "loss": 5e-5, "grad": 2e-2}
# CONF_025_TRAIN at tensor 2 (phase 18(d)): every FF and attention call at
# other shapes than unsharded, and the attention's bf16 partial outputs
# summed over the ranks, so more bf16 roundings differ than at domain 2
# (PERF.md, PR 19, calls 3-4 on one H100: the prediction 9.26e-3 / 8.65e-3
# - 9.14e-3 / 8.79e-3 - 9.30e-3, the loss 5.3e-7 and 9.5e-7, the gradient
# 1.21e-3 - 1.24e-3); a few times those. CONF_FUXI at tensor 2 keeps
# PAR_FUXI_TOL
PAR_TP_TOL = {"pred": (3e-2, 3e-2, 3e-2), "loss": 3e-6, "grad": PAR_GRAD_TOL}
# phase 18(e): the f32 models at domain 2 (the U-Net, graph): the
# prediction (each of its three figures), the loss (relative) and the
# gradient (its difference over its norm) within 1e-4; NextGen (bf16) is
# held to phase 18(b)'s limits
PAR_F32_TOL = {"pred": (1e-4, 1e-4, 1e-4), "loss": 1e-4, "grad": 1e-4}
# the most rows a slab's conv input may hold past half the unsharded one's:
# the stage-0 quadrant embed's halo of 15 rows a side (NextGen's largest
# input is that conv's input gradient: its dy padded by 7 rows a side,
# once on a slab as on the whole field, plus the 4 overlap rows the
# quadrant offsets cut: 182 rows against 342 on one H100 80GB HBM3 at
# 700 W, PERF.md); a 3x3 conv's one row a side
SLAB_HALO_ROWS = 15
# main path 15 (phase 18e): the models lat-sharded last. NextGen at
# CONF_NEXTGEN's widths, depths, windows, 64 virtual nodes and bf16 on
# 640x1280 (721 rows do not split over 2 and the validator refuses them):
# stage rows 320/160/80/40, 3,200 stage-3 nodes, the windows [10, 10, 10,
# 5] dividing every slab; the U-Net at credit_tpu's default encoder
# (64/128/256/512, f32) on 721x1440 with CONF_025_TRAIN's channels, padded
# to 728 rows (its deepest level, 91 rows, gathered); the graph at its
# default widths (hidden 256, 4 blocks, 4 heads, 6 neighbours) on 180x360
CONF_NG640 = {**CONF_NEXTGEN, "image_height": 640, "image_width": 1280}
_CHANNELS_025 = {k: CONF_025_TRAIN[k] for k in ("frames", "levels", "channels",
                                                 "surface_channels", "input_only_channels",
                                                 "output_only_channels")}
CONF_UNET_025 = {"type": "unet", "image_height": 721, "image_width": 1440, **_CHANNELS_025}
CONF_GRAPH_1DEG = {"type": "graph", "image_height": 180, "image_width": 360, **_CHANNELS_025}
PAR_RING_TOL = 1e-5  # ring against dense CRPS, relative, f32
PAR_HALO_TOL = (1e-3, 1.5e-2)  # benchmark_halo's forward and gradient errors
PAR_TIMEOUT = 600


def _par_conf(dims, model=None, data=None) -> dict:
    frames = (model or CONF_025_TRAIN).get("frames", 1)
    return {"model": model or CONF_025_TRAIN,
            "data": {**(data or DATA_025), "forecast_len": 1, "history_len": frames},
            "trainer": {**TRAINER, "parallelism": dict(zip(("data", "tensor", "domain"), dims))}}


def _par_step(torch, dims, batch_rows: int, rank: int, device: str = "cuda",
              model_conf=None, data=None, repeat: bool = False, time_ref: bool = False) -> dict:
    """One CONF_025_TRAIN train step (MSE, AdamW) of seeded weights on the
    mesh `dims` over the group, then, on rank 0, the unsharded step on the
    whole batch from the same weights: the losses, the gradients' error,
    each side's launches by kernel, the shapes kernels 1 and 2 were given
    on the mesh and the ms of a second mesh step; and before the step, the
    prediction of this rank's rows on the mesh (gathered whole at domain 2)
    against the unsharded forward's rows (eval mode, no gradient, a noisy
    model's draws from one seed on both sides): the largest difference
    over the largest value, the mean difference over the mean value, and
    the largest of the latitude rows' mean differences over the mean
    value (bf16 roundings spread over every row; a seam fault gathers in
    a few). Between the two mesh steps: the parameter bytes the rank holds,
    the bytes of the gradients the optimizer was given, the gradients left
    on the parameters, against the bytes ZeRO-3 should hold (each tensor's
    dp chunk where param_spec shards it over dp, else whole) and the whole
    model's. At tensor > 1 also the hidden width of every FF call, forward
    and backward (a rank's slice), and the all-reduces over the tp group
    with their bytes; for every step the bytes allocated before it.
    `model_conf` and `data` replace CONF_025_TRAIN and DATA_025 (the input
    takes the model's frames). `repeat`: the mesh step and the unsharded
    step each run twice from the same weights, and whether the two
    gradients are the same bits (else their difference over the norm) is
    returned; `time_ref`: the ms of a second unsharded step."""
    import torch.distributed as dist

    from credit_torch.convert_jax import seed_train_
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.models import load_model
    from credit_torch.ops import cuda_conv, cuda_ff
    from credit_torch.parallel import context as par_ctx
    from credit_torch.parallel import distributed as D
    from credit_torch.parallel.mesh import build_mesh
    from credit_torch.parallel.sharding import (ShardedOptimizer, param_spec, shard_batch,
                                                shard_parameters)
    from credit_torch.tools import cuda_ms
    from credit_torch.trainers.scheduler import load_scheduler
    from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step

    conf = _par_conf(dims, model_conf, data)
    mconf = conf["model"]
    schema = ChannelSchema.from_config(conf)
    cuda = device == "cuda"
    model = load_model(conf, device=device, sn_state=True)
    seed_train_(model, conf, torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator(device=device).manual_seed(5)
    h, w = mconf["image_height"], mconf["image_width"]
    frames = mconf.get("frames", 1)
    batch = {"x": torch.randn((batch_rows, frames, h, w, schema.n_input), generator=g,
                              device=device),
             "y": torch.randn((batch_rows, 1, h, w, schema.n_target), generator=g,
                              device=device)}
    names = [k for k, _ in model.named_parameters()]
    pshapes = [tuple(p.shape) for p in model.parameters()]
    whole_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

    def mse(y, p):
        return torch.mean((p.float() - y) ** 2)

    def run(model, mesh, b, timed=False):
        opt = make_optimizer(conf, load_scheduler(conf))
        if mesh is not None:
            opt = ShardedOptimizer(opt, mesh, names, pshapes)
        seen, inner = {}, opt.update

        def update(grads, st, params):  # the first step's gradient
            seen.setdefault("g", [x.detach().clone() for x in grads])
            return inner(grads, st, params)

        opt.update = update
        step = make_train_step(model, mse, opt, schema, device=device, mesh=mesh)
        state = TrainState.create(model, opt)
        shapes = {"conv": [], "ff": [], "hidden": [], "hidden_bwd": []}
        tp_ranks = (dist.get_process_group_ranks(mesh.group("tp"))
                    if mesh is not None and dims[1] > 1 else None)
        tp_reduce = [0, 0]  # the all-reduces over the tp group, and their bytes
        conv0, ff0, part0, pbwd0 = (cuda_conv.conv2d_valid, cuda_ff.fused_ff,
                                    cuda_ff.ff_partial, cuda_ff.ff_partial_bwd)
        reduce0 = D.all_reduce

        def conv_rec(x, k):
            shapes["conv"].append(tuple(x.shape))
            return conv0(x, k)

        def ff_rec(x, *a, **kw):
            shapes["ff"].append(tuple(x.shape[:-1]))
            shapes["hidden"].append(a[2].shape[1])
            return ff0(x, *a, **kw)

        def part_rec(x, g, b, w1, *a, **kw):  # a tp rank's FF: its hidden slice
            shapes["ff"].append(tuple(x.shape[:-1]))
            shapes["hidden"].append(w1.shape[1])
            return part0(x, g, b, w1, *a, **kw)

        def pbwd_rec(x, dz, g, b, w1, *a, **kw):
            shapes["hidden_bwd"].append(w1.shape[1])
            return pbwd0(x, dz, g, b, w1, *a, **kw)

        def reduce_rec(t, group=None, *a, **kw):
            if tp_ranks is not None and group is not None and \
                    dist.get_process_group_ranks(group) == tp_ranks:
                tp_reduce[0] += 1
                tp_reduce[1] += t.numel() * t.element_size()
            return reduce0(t, group, *a, **kw)

        # the wrappers count on their module's name, the recorders while they
        # stand in; their counts go back to the wrappers after
        recs = ((conv_rec, conv0, ("launches", "f32_launches")),
                (ff_rec, ff0, ("launches", "split_launches")),
                (part_rec, part0, ("launches",)), (pbwd_rec, pbwd0, ("launches",)))
        _zero_counts()
        for rec, _, attrs in recs:
            for a in attrs:
                setattr(rec, a, 0)
        D.COUNTS.clear()
        par_ctx.GATHERS.clear()
        bottleneck = getattr(model, "spectral_bottleneck", None)
        sums = bottleneck.slab_sums if bottleneck is not None else 0
        (cuda_conv.conv2d_valid, cuda_ff.fused_ff, cuda_ff.ff_partial,
         cuda_ff.ff_partial_bwd) = conv_rec, ff_rec, part_rec, pbwd_rec
        D.all_reduce = reduce_rec
        try:
            if cuda:
                before = torch.cuda.memory_allocated()
            state, metrics = step(state, b)
            if cuda:
                torch.cuda.synchronize()
            # the step's peak, what stays allocated after it (the held
            # parameters, the optimizer state, the batch) and what was
            # allocated before it
            mem = ((torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated(), before)
                   if cuda else (0, 0, 0))
        finally:
            (cuda_conv.conv2d_valid, cuda_ff.fused_ff, cuda_ff.ff_partial,
             cuda_ff.ff_partial_bwd) = conv0, ff0, part0, pbwd0
            D.all_reduce = reduce0
            for rec, wrapper, attrs in recs:
                for a in attrs:
                    setattr(wrapper, a, getattr(wrapper, a) + getattr(rec, a))
        counts, coll = _read_counts(), dict(D.COUNTS)
        gathers = dict(par_ctx.GATHERS)
        sums = bottleneck.slab_sums - sums if bottleneck is not None else 0
        loss = float(metrics["loss"])
        held = (sum(p.numel() * p.element_size() for p in model.parameters()),
                sum(x.numel() * x.element_size() for x in seen["g"]),
                sum(p.grad is not None for p in model.parameters()))
        grads = seen["g"]
        if mesh is not None:  # the held chunks whole, to compare
            grads = opt.held_whole(dict(zip(names, grads)))
        ms = None  # a timed second step: at tensor 2 and where asked (cut elsewhere for time)
        if timed and cuda:
            ms = cuda_ms(lambda: step(state, b), 1, warmup=0)
        elif mesh is not None and dims[1] > 1 and cuda:
            ms = cuda_ms(lambda: step(state, b), 1)
        elif mesh is not None and dims[1] > 1:
            t0 = time.perf_counter()
            step(state, b)
            ms = (time.perf_counter() - t0) * 1e3
        # the recorder's closure holds `seen`: put the optimizer's own update
        # back, so that no reference cycle keeps this step's gradients alive
        # into the next measurement (PERF.md, PR 19: rank 0's extra peak)
        opt.update = inner
        return {"loss": loss, "grads": grads, "counts": counts, "collectives": coll,
                "gathers": gathers, "slab_sums": sums,
                "conv_shapes": sorted(set(shapes["conv"])),
                "conv_rows": max([s[1] for s in shapes["conv"]], default=0),
                "ff_rows": max([math.prod(s) for s in shapes["ff"]], default=0),
                "hidden": shapes["hidden"], "hidden_bwd": shapes["hidden_bwd"],
                "tp_reduce": tp_reduce,
                "ms": ms, "held": held, "peak": mem[0], "allocated": mem[1],
                "before": mem[2]}

    mesh = build_mesh(*dims)
    mine = shard_batch(batch, mesh)
    expect = sum(math.prod(s) // dims[0] if "dp" in param_spec(k, s, mesh) else math.prod(s)
                 for k, s in zip(names, pshapes)) * 4
    model.eval()

    def draws():  # a noisy model's generator, the same on both sides
        return ({"generator": torch.Generator(device=device).manual_seed(7)}
                if getattr(model, "stochastic", False) else {})

    with torch.no_grad():
        if dims[0] > 1:
            # this rank's rows, unsharded, then through ZeRO-3's gathers
            want = model(mine["x"], **draws()).float()
            shard_parameters(model, mesh)
        else:
            want = model(batch["x"], **draws()).float()
        with par_ctx.explicit_halo(mesh):
            pred = model(mine["x"], **draws()).float()
    diff, scale = (pred - want).abs(), want.abs().mean()
    pred_err = (float(diff.max() / want.abs().max()), float(diff.mean() / scale),
                float((diff.mean(dim=(0, 1, 3, 4)) / scale).max()))
    del pred, want, diff
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    got = run(model, mesh, mine)

    def spread(a: list, b: list):
        """True where two gradients are the same bits, else the norm of
        their difference over b's."""
        if all(torch.equal(x, y) for x, y in zip(a, b)):
            return True
        return math.sqrt(sum(float((x.float() - y.float()).pow(2).sum()) for x, y in zip(a, b))
                         / sum(float(y.float().pow(2).sum()) for y in b))

    if repeat:  # the mesh step again, from the same weights
        model.load_state_dict(start)
        got["repeat"] = spread(run(model, mesh, mine)["grads"], got["grads"])
    # the graph: this rank's edges, all of them, the halo
    edges = ((len(model.slab_edges(dims[2], mesh.coord("domain"))[0]), len(model.edge_src),
              model.edge_halo) if hasattr(model, "slab_edges") else None)
    del model  # ZeRO-3 holds it in chunks: the unsharded step takes a fresh one
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    out = {**{k: v for k, v in got.items() if k != "grads"}, "pred_err": pred_err,
           "held_expected": expect, "whole_bytes": whole_bytes}
    if edges is not None:
        out["edges"] = edges
    if rank == 0:  # the unsharded step, from the same weights, rank 1 waiting
        model = load_model(conf, device=device, sn_state=True)
        model.load_state_dict(start)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ref = run(model, None, batch, timed=time_ref)
        out["ref_ms"] = ref["ms"]
        if repeat:
            model.load_state_dict(start)
            out["ref_repeat"] = spread(run(model, None, batch)["grads"], ref["grads"])
        out["ref_peak"], out["ref_allocated"] = ref["peak"], ref["allocated"]
        out["ref_before"], out["ref_hidden"] = ref["before"], ref["hidden"]
        num = sum(float((a.float() - b.float()).pow(2).sum()) for a, b in zip(got["grads"],
                                                                             ref["grads"]))
        den = sum(float(b.float().pow(2).sum()) for b in ref["grads"])
        out.update(ref_loss=ref["loss"], ref_counts=ref["counts"], ref_conv_rows=ref["conv_rows"],
                   ref_ff_rows=ref["ff_rows"], grad_rel=math.sqrt(num / den),
                   ref_held=ref["held"])
        del model, ref
    del start, batch, got
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _par_ring(torch, rank: int, device: str = "cuda", shape=(1, 721, 1440, 16)) -> dict:
    """Ring-CRPS over the dp group of 2 ranks, each its member of a seeded
    2-member 721x1440 ensemble of 16 fields, against the dense estimator
    on the same members: the values and the largest error of this rank's
    member's gradient, of its largest."""
    from credit_torch.parallel.mesh import build_mesh
    from credit_torch.parallel.ring_crps import dense_fair_crps, ring_crps

    mesh = build_mesh(2, 1, 1)
    g = torch.Generator(device=device).manual_seed(9)
    members = torch.randn((2, *shape), generator=g, device=device)
    target = torch.randn(shape, generator=g, device=device)
    mem = members[rank].clone().requires_grad_(True)
    loss = ring_crps(mem, target, mesh.group("dp"))
    loss.backward()
    m = members.clone().requires_grad_(True)
    dense = dense_fair_crps(m, target)
    dense.backward()
    want = m.grad[rank]
    return {"ring": loss.item(), "dense": dense.item(),
            "grad_err": float((mem.grad - want).abs().max() / want.abs().max())}


def parallel_rank(rank: int, world: int, root: str, device: str = "cuda",
                  halo_shape=(800, 1440, 128)) -> int:
    """One rank of phase 18(b-e): gloo over a FileStore in `root`, the
    card shared; writes root/rank<r>.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from credit_torch import _build
    from credit_torch.applications.benchmark import benchmark_halo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        _build.library()
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
    h, w, c = halo_shape
    out = {"domain2": _par_step(torch, (1, 1, 2), 1, rank, device),
           "ens_domain2": _par_step(torch, (1, 1, 2), 1, rank, device,
                                    {**CONF_025_TRAIN, "type": "crossformer-ensemble"}),
           "fuxi_domain2": _par_step(torch, (1, 1, 2), 1, rank, device, CONF_FUXI, DATA_FUXI),
           "dp2": _par_step(torch, (2, 1, 1), 2, rank, device),
           "fuxi_dp2": _par_step(torch, (2, 1, 1), 2, rank, device, CONF_FUXI, DATA_FUXI),
           "tp2": _par_step(torch, (1, 2, 1), 1, rank, device),
           "fuxi_tp2": _par_step(torch, (1, 2, 1), 1, rank, device, CONF_FUXI, DATA_FUXI),
           "ng_domain2": _par_step(torch, (1, 1, 2), 1, rank, device, CONF_NG640),
           "unet_domain2": _par_step(torch, (1, 1, 2), 1, rank, device, CONF_UNET_025,
                                     time_ref=True),
           "graph_domain2": _par_step(torch, (1, 1, 2), 1, rank, device, CONF_GRAPH_1DEG,
                                      repeat=True, time_ref=True),
           "ring": _par_ring(torch, rank, device, (1, 721, 1440, 16) if device == "cuda"
                             else (1, 16, 32, 4)),
           "halo": benchmark_halo(h=h, w=w, c=c, k=3, steps=5, dtype=torch.bfloat16,
                                  device=device)}
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def parallel_path(torch, store_info, runs: dict, want_train: dict, want_valid: dict) -> None:
    """Main path 15: (a) `credit train` through maybe_initialize (the
    CREDIT_* variables, a file:// rendezvous) over NCCL at world size 1,
    data: none, one step and one validation batch on main path 7's store,
    the launches checked and the gradient all-reduced over NCCL; (b, c)
    two ranks on the card over gloo (`parallel_rank`), each mesh step's
    launches equal to the unsharded step's (kernel 2 on slabs: its largest
    input has fewer rows than unsharded, as has kernel 1's), the loss and
    prediction within PAR_PRED_TOL of the unsharded forward's, the loss
    and gradient within PAR_LOSS_TOL / PAR_GRAD_TOL of the unsharded step,
    ring-CRPS within PAR_RING_TOL of the dense CRPS, and benchmark_halo's
    errors within PAR_HALO_TOL; (d) the same two ranks at tensor 2, each FF
    on its half of the hidden layer (`_tp_launches`), held as (b); (e) the
    models lat-sharded last (PAR_ZOO, `check_zoo_slabs`)."""
    import torch.distributed as dist

    from credit_torch.applications import run_training
    from credit_torch.parallel import distributed as D

    store, stats, data, _ = store_info
    root = os.path.join(os.path.dirname(store), "parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    conf = fit_conf(CONF_025_TRAIN, data, store, stats, os.path.join(root, "run"),
                    {**ZOO_TRAINER, "batches_per_epoch": 1, "parallelism": {"data": "none"}},
                    *FIT_WINDOWS)
    env = {"CREDIT_COORDINATOR": f"file://{os.path.join(root, 'nccl_store')}",
           "CREDIT_NUM_PROCESSES": "1", "CREDIT_PROCESS_ID": "0"}
    os.environ.update(env)
    t0 = time.time()
    _zero_counts()
    D.COUNTS.clear()
    try:
        state = run_training(conf)
        torch.cuda.synchronize()
        counts, coll = _read_counts(), dict(D.COUNTS)
        backend, world = dist.get_backend(), dist.get_world_size()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    rows = read_log(os.path.join(root, "run"))
    log(f"  (a) run_training through maybe_initialize: backend {backend}, world size {world}, "
        f"{time.time() - t0:.1f} s; collectives {coll}; log row {rows[1][:6]}; launches {counts}")
    if (backend != "nccl" or world != 1 or state.step != 1 or coll.get("all_reduce", 0) < 2
            or not all(math.isfinite(float(c)) for c in rows[1][1:])):
        raise AssertionError("phase 18(a): the NCCL world-size-1 fit failed its checks")
    _check_counts(counts, {k: want_train.get(k, 0) + want_valid.get(k, 0) for k in counts}, 1)
    runs["par_fit_nccl"] = counts
    del state
    torch.cuda.empty_cache()
    parallel_ranks(torch, root, runs)


def _tp_launches(counts: dict) -> dict:
    """An unsharded step's launches as a tp rank makes them: each FF call
    on the tp entries (kernel 1: ff_partial and ff_finish, kernel 4:
    ff_partial_bwd and ff_finish_bwd) in place of fused_ff (either route)
    and fused_ff_bwd; every other kernel as often."""
    out = {**counts, "fused_ff": 0, "fused_ff_split": 0, "fused_ff_bwd": 0}
    out.update(ff_partial=counts["fused_ff"], ff_finish=counts["fused_ff"],
               ff_partial_bwd=counts["fused_ff_bwd"], ff_finish_bwd=counts["fused_ff_bwd"])
    return out


def parallel_ranks(torch, root: str, runs: dict) -> None:
    """Phase 18(b-e): two processes of this script (`parallel_rank`)
    sharing the card over gloo in `root` (removed after), their results
    checked (`check_parallel`, see `parallel_path`)."""
    t0 = time.time()
    logs = [open(os.path.join(root, f"rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                               "--parallel-rank", str(r), "--parallel-dir", root],
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=max(PAR_TIMEOUT - (time.time() - t0), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        for r in range(2):
            with open(os.path.join(root, f"rank{r}.log")) as f:
                log(f"  rank {r} (rc {procs[r].returncode}):\n{f.read()[-4000:]}")
        raise AssertionError("phase 18(b-e): a rank failed")
    res = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    log(f"  (b-e) two ranks over gloo on one card: {time.time() - t0:.1f} s with start-up")
    ok = check_parallel(res, runs)
    shutil.rmtree(root, ignore_errors=True)
    if not ok:
        raise AssertionError("phase 18(b-e) failed its checks")


# phase 18(e)'s cases: (the kernels its step launches on every rank, the
# conv inputs phase 2 checks at its slab shapes, the gather paths a rank
# takes in one step, by site)
PAR_ZOO = {
    "ng_domain2": (("conv2d_valid", "fused_ff", "fused_window_attention", "fused_ff_bwd",
                    "conv2d_wgrad"), NG_SLAB_CONV_SHAPES,
                   # every long attention's windows span the slabs
                   {"long_attn": sum(CONF_NG640["depth"])}),
    "unet_domain2": (("conv2d_valid", "conv2d_wgrad"), UNET_SLAB_CONV_SHAPES,
                     # level 3's pools straddle the 91-row slabs of level 2
                     {"level": 1}),
    "graph_domain2": ((), (), {})}


def check_zoo_slabs(res: list, key: str, label: str) -> bool:
    """Phase 18(e)'s checks of a case beyond the prediction, loss and
    gradient: the kernels of its path launched on every rank, kernel 2's
    largest input at most half the unsharded one's rows plus
    SLAB_HALO_ROWS and kernel 1's on fewer rows, phase 2's slab shapes
    among kernel 2's inputs, the gather paths taken (and no other), the
    bottleneck's all-reduces (one a step where it has one), the graph's
    edges split, and each rank's peak below the unsharded step's (run on
    rank 0; rank 1 runs the same program)."""
    kernels, conv_shapes, gathers = PAR_ZOO[key]
    r0 = res[0][key]
    ok = True
    for r in range(2):
        rk = res[r][key]
        launched = all(rk["counts"][k] > 0 for k in kernels)
        rows_ok = rk["conv_rows"] <= r0["ref_conv_rows"] / 2 + SLAB_HALO_ROWS
        ff_ok = rk["ff_rows"] < r0["ref_ff_rows"] or r0["ref_ff_rows"] == 0
        seen = {s[1:] for s in rk["conv_shapes"]}
        shapes_ok = all((hp, wp, cin) in seen for _, (_, hp, wp, cin, *_) in conv_shapes)
        sums_ok = rk["slab_sums"] == (1 if key == "ng_domain2" else 0)
        edges = rk.get("edges")
        edges_ok = edges is None or edges[0] < edges[1]
        peak_ok = rk["peak"] < r0["ref_peak"]
        rank_ok = (launched and rows_ok and ff_ok and shapes_ok and sums_ok and edges_ok
                   and peak_ok and rk["gathers"] == gathers)
        launches = {k: rk["counts"][k] for k in kernels}
        log(f"  {label}: rank {r}: launches {launches}; kernel 2's largest input rows "
            f"{rk['conv_rows']} (unsharded {r0['ref_conv_rows']}, limit "
            f"{r0['ref_conv_rows'] / 2 + SLAB_HALO_ROWS:g}), kernel 1's rows "
            f"{rk['ff_rows']} ({r0['ref_ff_rows']}); phase 2's slab shapes among kernel 2's "
            f"inputs {shapes_ok}; gather paths {rk['gathers']} (expected {gathers}); the "
            f"bottleneck's all-reduces {rk['slab_sums']}"
            + (f"; edges {edges[0]} of {edges[1]}, halo {edges[2]} rows" if edges else "")
            + f"; peak {rk['peak'] / 2**30:.2f} GiB (the unsharded step's "
            f"{r0['ref_peak'] / 2**30:.2f}) {'ok' if rank_ok else 'FAIL'}")
        ok = ok and rank_ok
    return ok


def check_par_case(res: list, key: str, label: str, runs: dict) -> bool:
    """One case of `check_parallel`: its lines printed, True when its
    checks hold."""
    r0 = res[0][key]
    loss_rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    tp = key.endswith("tp2")
    want_counts = _tp_launches(r0["ref_counts"]) if tp else r0["ref_counts"]
    same = all(res[r][key]["counts"] == want_counts for r in range(2))
    dp = key.endswith("dp2")
    if tp:
        # every FF of the step on each rank at half the hidden width, in
        # the forward and the backward; the tokens not split
        half = sorted(hd // 2 for hd in r0["ref_hidden"])
        slabs = all(sorted(res[r][key]["hidden"]) == half
                    and sorted(res[r][key]["hidden_bwd"]) == half
                    and res[r][key]["ff_rows"] == r0["ref_ff_rows"] for r in range(2))
        log(f"  {label}: kernel 1's and 4's launches a rank "
            + ", ".join(f"rank {r} ff_partial {res[r][key]['counts']['ff_partial']}, "
                        f"ff_finish {res[r][key]['counts']['ff_finish']}, ff_partial_bwd "
                        f"{res[r][key]['counts']['ff_partial_bwd']}, ff_finish_bwd "
                        f"{res[r][key]['counts']['ff_finish_bwd']}" for r in range(2))
            + f" (the unsharded step's fused_ff {r0['ref_counts']['fused_ff']}, fused_ff_bwd "
            f"{r0['ref_counts']['fused_ff_bwd']}); hidden widths a rank ran at "
            f"{sorted(set(res[0][key]['hidden']))} (unsharded {sorted(set(r0['ref_hidden']))})"
            f"; tp all-reduces a step "
            + ", ".join(f"rank {r} {res[r][key]['tp_reduce'][0]} of "
                        f"{res[r][key]['tp_reduce'][1] / 2**20:.1f} MiB" for r in range(2))
            + f"; allocated before the step rank 0 {r0['before'] / 2**30:.2f}, rank 1 "
            f"{res[1][key]['before'] / 2**30:.2f} GiB (unsharded "
            f"{r0['ref_before'] / 2**30:.2f}) {'ok' if slabs else 'FAIL'}")
    elif key in PAR_ZOO:
        slabs = check_zoo_slabs(res, key, label)
    else:
        slabs = (r0["ff_rows"] < r0["ref_ff_rows"] if dp else
                 r0["conv_rows"] < r0["ref_conv_rows"] and r0["ff_rows"] < r0["ref_ff_rows"])
    # between the steps a rank holds its ZeRO-3 chunks and the whole
    # small tensors, as parameters and as the gradients it reduces, and
    # leaves no gradient on the parameters
    held = [res[r][key]["held"] for r in range(2)]
    held_ok = all(hb[0] == hb[1] == res[r][key]["held_expected"] and hb[2] == 0
                  for r, hb in enumerate(held))
    if dp:
        held_ok = held_ok and r0["held_expected"] < r0["whole_bytes"]
    log(f"  {label}: held between the steps, parameters / gradients a rank: "
        + ", ".join(f"rank {r} {hb[0] / 2**30:.4f} / {hb[1] / 2**30:.4f} GiB"
                    for r, hb in enumerate(held))
        + f" (expected {r0['held_expected'] / 2**30:.4f}; the whole model "
        f"{r0['whole_bytes'] / 2**30:.4f}, the unsharded step's "
        f"{r0['ref_held'][0] / 2**30:.4f} / {r0['ref_held'][1] / 2**30:.4f}) "
        f"{'ok' if held_ok else 'FAIL'}")
    perr = [max(res[r][key]["pred_err"][i] for r in range(2)) for i in range(3)]
    lim = (PAR_FUXI_TOL if key.startswith("fuxi") else PAR_TP_TOL if tp else
           PAR_F32_TOL if key in ("unet_domain2", "graph_domain2") else
           {"pred": PAR_PRED_TOL, "loss": PAR_LOSS_TOL, "grad": PAR_GRAD_TOL})
    log(f"  {label}: prediction's difference from the unsharded forward's, largest over "
        f"largest, mean over mean, worst row's mean over mean: rank 0 "
        f"{', '.join(f'{e:.3e}' for e in res[0][key]['pred_err'])}, rank 1 "
        f"{', '.join(f'{e:.3e}' for e in res[1][key]['pred_err'])} (limits "
        f"{lim['pred']}); loss "
        f"{r0['loss']:.8f} vs unsharded {r0['ref_loss']:.8f} (rel "
        f"{loss_rel:.3e}, limit {lim['loss']:g}); gradient rel {r0['grad_rel']:.3e} (limit "
        f"{lim['grad']:g}); launches a rank {res[0][key]['counts']}, {res[1][key]['counts']}"
        f" = unsharded {same}; kernel 2's largest input rows {r0['conv_rows']} (unsharded "
        f"{r0['ref_conv_rows']}), kernel 1's rows {r0['ff_rows']} ({r0['ref_ff_rows']}); "
        f"collectives {r0['collectives']}; "
        + (f"second step {res[0][key]['ms']:.1f} / {res[1][key]['ms']:.1f} ms, "
           if r0["ms"] is not None else "")
        + f"peak a rank {r0['peak'] / 2**30:.2f}, "
        f"{res[1][key]['peak'] / 2**30:.2f} GiB (the unsharded step's "
        f"{r0['ref_peak'] / 2**30:.2f}), allocated before the step "
        f"{r0['before'] / 2**30:.2f}, {res[1][key]['before'] / 2**30:.2f} GiB "
        f"({r0['ref_before'] / 2**30:.2f}), after it "
        f"{r0['allocated'] / 2**30:.2f}, {res[1][key]['allocated'] / 2**30:.2f} GiB "
        f"({r0['ref_allocated'] / 2**30:.2f}; two ranks on one card: no throughput figure)")
    if r0.get("ref_ms") is not None:
        log(f"  {label}: the unsharded step on one card (rank 1 waiting): "
            f"{r0['ref_ms']:.1f} ms/step (its second call), peak {r0['ref_peak'] / 2**30:.2f} GiB")
    repeat_ok = True
    if "repeat" in r0:
        # the fixed-order segment sums: a step's gradient, twice, the same bits
        spreads = [res[r][key]["repeat"] for r in range(2)] + [r0["ref_repeat"]]
        repeat_ok = all(x is True for x in spreads)
        log(f"  {label}: two calls of the same step, gradients the same bits (or their "
            f"difference over the norm): mesh rank 0 {spreads[0]}, rank 1 {spreads[1]}, "
            f"unsharded {spreads[2]} {'ok' if repeat_ok else 'FAIL'}")
    ok = (all(e <= t for e, t in zip(perr, lim["pred"]))
          and loss_rel <= lim["loss"] and repeat_ok
          and r0["grad_rel"] <= lim["grad"] and same and slabs and held_ok)
    runs[f"par_{key}"] = {k: res[0][key]["counts"][k] + res[1][key]["counts"][k]
                          for k in r0["counts"]}
    return ok


# phase 18's two-rank cases: (key in parallel_rank's results, label)
PAR_CASES = (("domain2", "(b) domain 2, halo explicit, batch 1"),
             ("ens_domain2", "(b) crossformer-ensemble, domain 2, batch 1"),
             ("fuxi_domain2", "(b) CONF_FUXI, domain 2, batch 1"),
             ("dp2", "(c) data 2 under ZeRO-3, batch 2 (1 a rank)"),
             ("fuxi_dp2", "(c) CONF_FUXI, data 2 under ZeRO-3, batch 2 (1 a rank)"),
             ("tp2", "(d) tensor 2, batch 1"),
             ("fuxi_tp2", "(d) CONF_FUXI, tensor 2, batch 1"),
             ("ng_domain2", "(e) NextGen at 640x1280 (CONF_NG640), domain 2, batch 1"),
             ("unet_domain2", "(e) U-Net at 721x1440 (CONF_UNET_025, f32), domain 2, batch 1"),
             ("graph_domain2", "(e) graph at 180x360 (CONF_GRAPH_1DEG, f32), domain 2, batch 1"))


def check_parallel(res: list, runs: dict) -> bool:
    """The checks of phase 18(b-e) on the two ranks' results (their
    `parallel_rank` dicts); each mesh step's launches summed over the ranks
    into runs['par_<key>']. True when every check holds."""
    ok = True
    for key, label in PAR_CASES:
        ok = check_par_case(res, key, label, runs) and ok
    ring = [x["ring"] for x in res]
    dense = ring[0]["dense"]
    gerr = max(x["grad_err"] for x in ring)
    rerr = max(abs(x["ring"] - dense) for x in ring) / abs(dense)
    log(f"  (c) ring-CRPS at 2 members: {[x['ring'] for x in ring]} vs dense {dense:.8f} (rel "
        f"{rerr:.3e}), gradient rel {gerr:.3e} (limit {PAR_RING_TOL:g})")
    halo = res[0]["halo"]
    log(f"  benchmark_halo {halo['shape']} bf16 k3 x{halo['steps']}: fwd err "
        f"{halo['fwd_err_explicit']:.3e}, grad err {halo['grad_err_explicit']:.3e}, collectives "
        f"a step {halo['collectives_explicit']}, ms a step explicit "
        f"{halo['ms_per_step_explicit']:.3f} (slowest rank "
        f"{halo['ms_per_step_explicit_max_rank']:.3f}), unsharded "
        f"{halo['ms_per_step_unsharded']:.3f} (limits {PAR_HALO_TOL})")
    ok = (ok and rerr <= PAR_RING_TOL and gerr <= PAR_RING_TOL
          and halo["fwd_err_explicit"] <= PAR_HALO_TOL[0]
          and halo["grad_err_explicit"] <= PAR_HALO_TOL[1])
    return ok


# main path 16, the applications and interfaces: the published wxformer_6h
# and fuxi_6h layouts (credit_torch.manifests, 640x1280 padded 80 a side to
# 800x1440; 16 levels, 74 inputs, 71 outputs) converted by `credit-torch
# convert-checkpoint --dry-run-manifest`, a seeded GFS-like analysis at
# 0.25 degrees (721x1440, 13 pressure levels) through `credit-torch
# realtime`, `credit-torch serve` on localhost, one FuXi step
WX_LEVELS = [5000.0, 10000.0, 15000.0, 20000.0, 25000.0, 30000.0, 40000.0, 50000.0, 60000.0,
             70000.0, 77500.0, 85000.0, 90000.0, 92500.0, 95000.0, 100000.0]
GFS_LEVELS = [5000.0, 10000.0, 15000.0, 20000.0, 25000.0, 30000.0, 40000.0, 50000.0, 60000.0,
              70000.0, 85000.0, 92500.0, 100000.0]
GFS_SHAPE = (721, 1440)
WX_SHAPE = (640, 1280)
WX_SURFACE = ["SP", "VAR_2T", "VAR_10U", "VAR_10V", "Z500", "T500", "U500"]
DATA_WX = {"source": {"ERA5": {
    "levels": WX_LEVELS,
    "variables": {"prognostic": {"vars_3D": ["U", "V", "T", "Q"], "vars_2D": WX_SURFACE},
                  "dynamic_forcing": {"vars_2D": ["tsi"]},
                  "static": {"vars_2D": ["z_norm", "lsm"]}}}}}
# the GFS short names of the 3-D and the mapped surface fields (nwp.GFS_MAP);
# Z500, T500 and U500 go in under their ERA5 names
GFS_3D = {"ugrd": "U", "vgrd": "V", "tmp": "T", "spfh": "Q"}
GFS_2D = {"pressfc": "SP", "tmp2m": "VAR_2T", "ugrd10m": "VAR_10U", "vgrd10m": "VAR_10V",
          "Z500": "Z500", "T500": "T500", "U500": "U500"}
WX_TIMES = 6  # the store's six-hourly times: init 1 and the forcing of 4 steps
RT_STEPS = 4
GEFS_MEMBERS = 3
GEFS_STEPS = 2
SERVE_REQUESTS = 3
SERVE_STEPS = 4
IC_TOL = 1e-5  # of each channel's largest |value|
IC_ROW_STRIDE = 16  # the CPU's IC on every 16th row of the 640
SERVE_MEAN_TOL = 1e-4  # relative: the same bf16 forward, request against in-process run
RT_LABEL = "2024-01-01T00Z"
FX_STEPS = 3
# the converted FuXi's bf16 step through kernels 1 and 2, from an f32
# forward on the plain versions, against the bf16 step on the plain
# versions' distance from it: both are bf16 rounding
FX_PLAIN_FACTOR = 1.5


def _wx_conf(model: dict, root: str, store: str, stats, history_len: int = 1, **extra) -> dict:
    """A config of the published layout on the seeded 640x1280 store: the
    zarr source, the Normalizer from its statistics, bf16 compute."""
    src = {**DATA_WX["source"]["ERA5"], "dataset_type": "zarr", "store_path": store}
    return {"model": {**model, "compute_dtype": "bfloat16"}, "save_loc": root, "seed": 0,
            "data": {"source": {"ERA5": src}, "start_datetime": "1979-01-01T00",
                     "end_datetime": "1979-01-02T06", "timestep": "6h",
                     "history_len": history_len, "forecast_len": 1,
                     "mean_path": stats[0], "std_path": stats[1]},
            "loss": {"training_loss": "mse", "use_latitude_weights": True},
            "trainer": {"train_batch_size": 1, "preflight": False}, **extra}


def _write_json(path: str, conf: dict) -> str:
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


def gfs_cube(torch, path: str, seed: int) -> None:
    """A seeded GFS-like analysis as the decoded-fields .npz realtime reads:
    lat 90..-90 (721), lon 0..359.75 (1440), pressure GFS_LEVELS (Pa), the
    3-D fields (13, 721, 1440) and the 2-D ones (721, 1440) in physical
    units around STATS (N(0, 1) for the rest), drawn on the card."""
    import numpy as np

    g = torch.Generator(device="cuda").manual_seed(seed)
    fields = {}
    for name, var in {**GFS_3D, **GFS_2D}.items():
        m, s = STATS.get(var, (0.0, 1.0))
        shape = ((len(GFS_LEVELS),) if name in GFS_3D else ()) + GFS_SHAPE
        fields[name] = (torch.randn(shape, generator=g, device="cuda") * s + m).cpu().numpy()
    np.savez(path, lat=np.linspace(90.0, -90.0, GFS_SHAPE[0]),
             lon=np.arange(GFS_SHAPE[1]) * (360.0 / GFS_SHAPE[1]),
             pressure=np.asarray(GFS_LEVELS), **fields)


def convert_manifests(root: str):
    """`python -m credit_torch convert-checkpoint cfg --dry-run-manifest
    NAME` for wxformer_6h and fuxi_6h, both started at once; returns the
    processes, their configs and start times."""
    from credit_torch.manifests import MANIFEST_MODEL_CONF

    procs = {}
    for name, frames in (("wxformer_6h", 1), ("fuxi_6h", 2)):
        save = os.path.join(root, name)
        data = {"source": {"ERA5": DATA_WX["source"]["ERA5"]}, "history_len": frames}
        cfg = _write_json(os.path.join(root, f"{name}.json"),
                          {"model": MANIFEST_MODEL_CONF[name], "data": data, "save_loc": save})
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "credit_torch", "convert-checkpoint", cfg,
             "--dry-run-manifest", name], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), save, time.time())
    return procs


def finish_conversions(procs) -> dict:
    """Wait for the conversions; each must exit 0 and print its checkpoint
    directory. Prints each one's seconds and its parameter counts (the
    manifest's elements; the port model's parameters, from its log).
    Returns {name: checkpoint directory}."""
    import re

    from credit_torch.manifests import load_manifest

    out = {}
    for name, (proc, save, t0) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        secs = time.time() - t0
        if proc.returncode != 0 or stdout.strip().splitlines()[-1:] != [
                os.path.join(save, "checkpoint")]:
            raise AssertionError(f"convert-checkpoint {name}: rc {proc.returncode}\n"
                                 f"{stdout[-2000:]}\n{stderr[-4000:]}")
        m = re.search(r"(\d+) tensors, (\d+) parameters", stderr)
        manifest = sum(math.prod(s) for s in load_manifest(name).values())
        log(f"  credit-torch convert-checkpoint --dry-run-manifest {name}: {secs:.1f} s (the "
            f"two at once, a process each: start, synthesis, conversion, strict load on the "
            f"card, write); manifest {len(load_manifest(name))} keys, {manifest / 1e6:.2f} M "
            f"elements; the port's model {m.group(1)} tensors, {int(m.group(2)) / 1e6:.2f} M "
            f"parameters; {os.path.getsize(os.path.join(save, 'checkpoint', 'state.pt')) / 1e6:.0f}"
            f" MB state.pt")
        out[name] = save
    return out


def realtime_path(torch, conf: dict, cfg: str, want: dict, runs: dict):
    """Phase 19(b): `credit-torch realtime` (cli.main in this process) of
    the converted wxformer_6h in bf16 for RT_STEPS steps from the GFS cube,
    then the GEFS form with GEFS_MEMBERS members for GEFS_STEPS steps.
    Checks: the IC built on the card against nwp.build_gfs_init on the CPU
    at every IC_ROW_STRIDE-th row within IC_TOL of each channel's largest
    value; each file against RolloutEngine.step of the folded converted
    weights (NC_TOL); the launches a step; the GEFS files, its control's
    first step against the single run's and the members apart. Prints the
    IC's ms, ms/step with the writes and peak memory."""
    import io

    import numpy as np

    from credit_torch import nwp, output, rollout
    from credit_torch.applications import experiment
    from credit_torch.cli.main import main as cli
    from credit_torch.grid import Grid
    from credit_torch.trainers.trainer import Trainer
    from credit_torch.utils.ncio import open_dataset

    ics, runs_ms = [], []
    build, engine_run = nwp.build_gfs_init, rollout.RolloutEngine.run

    def timed_build(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ic = build(*args, **kw)
        torch.cuda.synchronize()
        ics.append(((time.perf_counter() - t0) * 1e3, args, kw, ic))
        return ic

    def timed_run(self, *args, **kw):
        t0 = time.perf_counter()
        res = engine_run(self, *args, **kw)
        runs_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    out = conf["realtime"]["save_forecast"]
    results = {}
    for tag, steps, argv in (("rt_wx", RT_STEPS, ["realtime", cfg]),
                             ("rt_gefs", GEFS_STEPS, ["realtime", cfg + ".gefs.json"])):
        ics.clear()
        runs_ms.clear()
        nwp.build_gfs_init, rollout.RolloutEngine.run = timed_build, timed_run
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        printed = io.StringIO()
        try:
            t0 = time.time()
            with contextlib.redirect_stdout(printed):
                rc = cli(argv)
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
        finally:
            nwp.build_gfs_init, rollout.RolloutEngine.run = build, engine_run
        n_files = len(printed.getvalue().split())
        if rc != 0 or n_files != steps * (GEFS_MEMBERS if tag == "rt_gefs" else 1):
            raise AssertionError(f"credit-torch {' '.join(argv)}: exit {rc}, {n_files} files")
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        n_ic = len(ics)
        log(f"  credit-torch realtime ({tag}: {n_ic} IC{'s' if n_ic > 1 else ''} x {steps} "
            f"steps): {wall:.0f} ms end to end; IC {[round(i[0], 1) for i in ics]} ms on the "
            f"card (regrid {GFS_SHAPE[0]}x{GFS_SHAPE[1]} -> {WX_SHAPE[0]}x{WX_SHAPE[1]} and the "
            f"column interpolation {len(GFS_LEVELS)} -> {len(WX_LEVELS)} levels); "
            f"{runs_ms[0] / steps:.1f} ms/step with the writes; peak memory {peak} bytes "
            f"({peak / 2**30:.2f} GiB); launches {counts}")
        _check_counts(counts, want, steps)
        runs[tag] = counts
        results[tag] = [i[3] for i in ics]
        if tag == "rt_wx":
            _, args, kw, ic = ics[0]
            schema, grid = args[0], args[1]
            rows = slice(None, None, IC_ROW_STRIDE)
            sub = Grid(lat=grid.lat[rows], lon=grid.lon, levels=grid.levels)
            t0 = time.time()
            cpu = build(schema, sub, *args[2:],
                        **{**kw, "device": "cpu", "static_fields": {
                            k: v[rows] for k, v in kw["static_fields"].items()}})
            card = ic[:, :, rows].double().cpu()
            scale = card.abs().amax(dim=(0, 1, 2, 3)).clamp_min(1e-30)
            err = ((card - cpu.double()).abs().amax(dim=(0, 1, 2, 3)) / scale).max().item()
            log(f"  the IC on the card against nwp.build_gfs_init on the CPU at every "
                f"{IC_ROW_STRIDE}th row ({cpu.shape[2]} rows, {time.time() - t0:.1f} s): worst "
                f"channel err over its largest value {err:.3e} limit {IC_TOL:g}")
            if not err <= IC_TOL:
                raise AssertionError("the realtime IC on the card disagrees with the CPU")

    # every single-run file against RolloutEngine.step of the folded weights
    exp = experiment.build_data(conf)
    schema = exp["schema"]
    saved = torch.load(os.path.join(conf["save_loc"], "checkpoint", Trainer.CHECKPOINT_FILE),
                       map_location="cuda", weights_only=True)
    model = experiment._inference_model(conf, saved["model"], torch.device("cuda"))
    del saved
    engine = rollout.RolloutEngine(model, schema, exp["normalizer"], device="cuda")
    x = exp["normalizer"].normalize_input(results["rt_wx"][0])
    worst, t0 = 0.0, time.time()
    first, step_ms = {}, []
    for s in range(RT_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y, x = engine.step(x)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        y = exp["normalizer"].denormalize_target(y).float()[0].cpu().numpy()
        path = os.path.join(out, RT_LABEL, f"pred_{RT_LABEL}_{6 * (s + 1):03d}.nc")
        ds = open_dataset(path)
        for k, a in output.split_channels(y, schema).items():
            w = np.asarray(ds[k].values)[0]
            if not np.isfinite(w).all() or w.shape != a[0].shape:
                raise AssertionError(f"{path}: {k} {w.shape} not finite or misshapen")
            worst = max(worst, float(np.abs(a[0] - w).max() / np.abs(w).max()))
            if s == 0:
                first[k] = w
    engine.close()
    del model, engine
    log(f"  the {RT_STEPS} files against RolloutEngine.step of the folded converted weights, "
        f"denormalized: worst variable rel err {worst:.3e} limit {NC_TOL:g} (read back in "
        f"{time.time() - t0:.1f} s); those steps alone {[round(v, 1) for v in step_ms]} ms "
        f"(f32 weights as the engine holds them, bf16 compute)")
    if not worst <= NC_TOL:
        raise AssertionError("the realtime forecast disagrees with the engine's step")
    members = sorted(os.listdir(out))
    names = sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out)
                   for f in fs)
    want_names = sorted([os.path.join(RT_LABEL, f"pred_{RT_LABEL}_{6 * (s + 1):03d}.nc")
                         for s in range(RT_STEPS)]
                        + [os.path.join(m, RT_LABEL, f"pred_{RT_LABEL}_{6 * (s + 1):03d}.nc")
                           for m in ("c00", "p01", "p02") for s in range(GEFS_STEPS)])
    if names != want_names:
        raise AssertionError(f"realtime files {names}, expected {want_names}")
    ctrl, pert = ({k: np.asarray(open_dataset(os.path.join(
        out, m, RT_LABEL, f"pred_{RT_LABEL}_006.nc"))[k].values)[0] for k in first}
        for m in ("c00", "p01"))
    same = max(float(np.abs(ctrl[k] - first[k]).max() / np.abs(first[k]).max()) for k in first)
    apart = max(float(np.abs(pert[k] - ctrl[k]).max() / np.abs(ctrl[k]).max()) for k in first)
    log(f"  GEFS ({members}): the control's first step against the single run's (batch 3 "
        f"against 1) worst rel err {same:.3e} limit {NC_TOL:g}; p01 apart from c00 by "
        f"{apart:.3e} of the largest value")
    if not (same <= NC_TOL and apart > 1e-3):
        raise AssertionError("the GEFS realtime members are wrong")
    return results["rt_wx"][0]


def serve_path(torch, conf: dict, want: dict, runs: dict) -> None:
    """Phase 19(c): ForecastService over the converted wxformer_6h and the
    640x1280 store, `serve`'s server (make_server) on 127.0.0.1 in a
    thread: GET /health, SERVE_REQUESTS POST /forecast of SERVE_STEPS
    steps (their launches counted), each step's mean against the engine run
    in this process within SERVE_MEAN_TOL, and GET /field's payload against
    the realtime file bitwise. Prints the load seconds and each request's
    ms (the client's wall time and the server's)."""
    import base64
    import threading
    import urllib.request

    import numpy as np

    from credit_torch.serve import ForecastService, make_server
    from credit_torch.utils.ncio import open_dataset

    svc = ForecastService(conf)
    httpd = make_server(conf, "127.0.0.1", 0, service=svc)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def request(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(url + path, data=data),
                                    timeout=300) as r:
            payload = json.loads(r.read())
            if r.status != 200:
                raise AssertionError(f"{path}: HTTP {r.status} {payload}")
        return payload, (time.perf_counter() - t0) * 1e3

    try:
        health, _ = request("/health")
        _zero_counts()
        answers = [request("/forecast", {"steps": SERVE_STEPS}) for _ in range(SERVE_REQUESTS)]
        counts = _read_counts()
        field, field_ms = request(f"/field?run_date={RT_LABEL}&forecast_hour=6&variable=T"
                                  f"&level=3")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")
    log(f"  credit-torch serve: model loaded in {health['load_seconds']:.1f} s; "
        f"{SERVE_REQUESTS} POST /forecast of {SERVE_STEPS} steps: client ms "
        f"{[round(ms, 1) for _, ms in answers]} (the zarr read of the IC and the forcing on "
        f"the host included), server ms {[round(a['seconds'] * 1e3, 1) for a, _ in answers]} "
        f"(the locked rollout: {SERVE_STEPS} bf16 steps, each prediction to the host); "
        f"launches {counts}")
    _check_counts(counts, want, SERVE_REQUESTS * SERVE_STEPS)
    runs["serve_wx"] = counts
    ds = svc.exp["dataset"]
    i0 = svc.history_len
    outs = svc.engine.run(ds.input_at(i0)[None], SERVE_STEPS,
                          forcing_provider=lambda s: ds.forcing_at(i0 + s)[None])
    ref = np.array([float(np.mean(o)) for o in outs])
    err = max(float(np.abs(np.array(a["channel_mean_per_step"]) - ref).max()
                    / np.abs(ref).max()) for a, _ in answers)
    svc.engine.close()
    log(f"  each step's mean of the {SERVE_REQUESTS} answers against the engine run in this "
        f"process: worst rel err {err:.3e} limit {SERVE_MEAN_TOL:g}")
    if not (err <= SERVE_MEAN_TOL and all(a["shapes"] == [list(outs[0].shape)]
                                          for a, _ in answers)):
        raise AssertionError("the server's forecasts disagree with the in-process run")
    arr = np.frombuffer(base64.b64decode(field["data"]), np.float32).reshape(field["shape"])
    want_t = np.asarray(open_dataset(os.path.join(
        conf["predict"]["save_forecast"], RT_LABEL, f"pred_{RT_LABEL}_006.nc"))["T"].values)[0, 3]
    log(f"  GET /field (T at level 3 of the realtime tree's first file): {field_ms:.1f} ms, "
        f"shape {field['shape']}, bitwise the file's: {bool(np.array_equal(arr, want_t))}")
    if not (field["status"] == "ok" and np.array_equal(arr, want_t)):
        raise AssertionError("GET /field disagrees with the file")
    del svc


@contextlib.contextmanager
def plain_routes(torch):
    """Within this block kernels 1 and 2 run their plain versions (the
    wrappers' module attributes pointed at them; the FF on the plain version
    of the route its plan picks), launching nothing."""
    from credit_torch.ops import cuda_conv, cuda_ff

    def ff_plain(x, g, b, w1, b1, w2, b2, post_norm=False):
        plan = cuda_ff.ff_plan(x.numel() // x.shape[-1], x.shape[-1], w1.shape[1], x.dtype,
                               bool(post_norm))
        fn = cuda_ff.fused_ff_split_plain if plan.route == "split" else cuda_ff.fused_ff_plain
        return fn(x, g, b, w1, b1, w2, b2, post_norm=post_norm)

    kernels = cuda_conv.conv2d_valid, cuda_ff.fused_ff
    cuda_conv.conv2d_valid, cuda_ff.fused_ff = cuda_conv.conv2d_valid_plain, ff_plain
    try:
        yield
    finally:
        cuda_conv.conv2d_valid, cuda_ff.fused_ff = kernels


def fuxi_step_path(torch, conf: dict, want: dict, runs: dict) -> None:
    """Phase 19(d): the converted fuxi_6h folded for inference in bf16
    (experiment._load_engine on the store, two input frames, f32 weights
    as the engine holds them): a warm-up step, FX_STEPS timed steps, the
    first one's launches counted, and one step profiled by kernel. Then
    the step's prediction held against the same step on the plain versions
    of kernels 1 and 2 (`plain_routes`), and both against an f32 forward on
    the plain versions: the kernels' distance from it within FX_PLAIN_FACTOR
    times the plain versions'. Prints ms a step and peak memory."""
    from credit_torch.applications import experiment
    from credit_torch.trainers.trainer import Trainer

    exp, engine = experiment._load_engine(conf, torch.device("cuda"), postblocks=False)
    ds = exp["dataset"]
    # the two frames on the card once (485 MB in f32), so a step copies none
    x_host = exp["normalizer"].normalize_input(torch.as_tensor(ds.input_at(ds.history_len)[None]))
    x = x_host.to("cuda")
    engine.step(x)
    ms, counts = [], None
    torch.cuda.reset_peak_memory_stats()
    for _ in range(FX_STEPS):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = engine.step(x)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = counts or _read_counts()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step(x_host)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    log(f"  fuxi_6h, bf16 forecast steps (two input frames, {WX_SHAPE[0]}x{WX_SHAPE[1]} padded to "
        f"800x1440): {[round(v, 1) for v in ms]} ms, peak {peak} bytes ({peak / 2**30:.2f} GiB); "
        f"output {tuple(y.shape)}; launches {counts}; a step handed the input on the host (its "
        f"{x_host.numel() * 4 / 1e6:.0f} MB copied in the step): {host_ms:.1f} ms")
    _check_counts(counts, want, 1)
    profile_steps(torch, "fuxi_6h engine step", lambda: engine.step(x), (), steps=1)
    with plain_routes(torch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_plain, _ = engine.step(x)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    engine.close()
    del engine
    saved = torch.load(os.path.join(conf["save_loc"], "checkpoint", Trainer.CHECKPOINT_FILE),
                       map_location="cuda", weights_only=True)
    conf32 = {**conf, "model": {**conf["model"], "compute_dtype": "float32"}}
    model32 = experiment._inference_model(conf32, saved["model"], torch.device("cuda"))
    del saved
    with plain_routes(torch), torch.no_grad():
        y32 = model32(x).double()
    del model32

    def dist(a, b):
        return float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))

    k_plain, k32, p32 = dist(y, y_plain.double()), dist(y, y32), dist(y_plain, y32)
    fin = bool(torch.isfinite(y).all())
    log(f"  the step against the same step on the plain versions ({plain_ms:.1f} ms): relative "
        f"L2 distance {k_plain:.3e}, largest |difference| over largest |plain| "
        f"{_rel(y.float(), y_plain.float()):.3e}; from an f32 forward on the plain versions: "
        f"the kernels' {k32:.3e}, the plain versions' {p32:.3e} (limit {FX_PLAIN_FACTOR:g} x "
        f"theirs); finite {fin}")
    if not (fin and k32 <= FX_PLAIN_FACTOR * p32):
        raise AssertionError("the converted FuXi's step disagrees with its plain versions")
    runs["fx_6h"] = counts


def write_inputs(torch, root: str):
    """The seeded WX_SHAPE zarr store of DATA_WX (WX_TIMES times) and
    GEFS_MEMBERS GFS cubes, the first the single run's. Returns (store,
    stats, {member: cube path})."""
    store = os.path.join(root, "era5.zarr")
    stats = write_store(torch, store, DATA_WX, WX_SHAPE, WX_TIMES, seed=19)
    cubes = {}
    for m in range(GEFS_MEMBERS):
        cubes["c00" if m == 0 else f"p{m:02d}"] = os.path.join(root, f"gfs_{m}.npz")
        gfs_cube(torch, cubes["c00" if m == 0 else f"p{m:02d}"], seed=190 + m)
    return store, stats, cubes


def applications_path(torch, runs: dict, root: str, saves: dict, store: str, stats, cubes: dict,
                      models: dict) -> None:
    """Phase 19(b-d) on the checkpoints in `saves` ({name: save_loc}) of
    `models` ({name: model config}, the manifests' in the run)."""
    wx = models["wxformer_6h"]
    out = os.path.join(root, "realtime")
    conf = _wx_conf(wx, saves["wxformer_6h"], store, stats, predict={"save_forecast": out},
                    realtime={"fields_path": cubes["c00"], "forecast_steps": RT_STEPS,
                              "init_label": RT_LABEL, "save_forecast": out})
    cfg = _write_json(os.path.join(root, "realtime.json"), conf)
    _write_json(cfg + ".gefs.json", {**conf, "realtime": {
        "member_fields_paths": cubes, "forecast_steps": GEFS_STEPS, "init_label": RT_LABEL,
        "save_forecast": out}})
    want = expected_per_step(wx)
    t0 = time.time()
    realtime_path(torch, conf, cfg, want, runs)
    torch.cuda.empty_cache()
    log(f"  phase 19(b): {time.time() - t0:.1f} s")
    t0 = time.time()
    serve_path(torch, conf, want, runs)
    torch.cuda.empty_cache()
    log(f"  phase 19(c): {time.time() - t0:.1f} s")
    t0 = time.time()
    fx = models["fuxi_6h"]
    fuxi_step_path(torch, _wx_conf(fx, saves["fuxi_6h"], store, stats, history_len=2),
                   expected_fuxi_per_step(fx), runs)
    torch.cuda.empty_cache()
    log(f"  phase 19(d): {time.time() - t0:.1f} s")


def interfaces_path(torch, runs: dict) -> None:
    """Main path 16 (phase 19): (a) the two published layouts converted by
    subprocesses of `python -m credit_torch` while `write_inputs` writes
    the store and the GFS cubes; (b) `realtime_path`; (c) `serve_path`;
    (d) `fuxi_step_path`. Removes its directory."""
    from credit_torch.manifests import MANIFEST_MODEL_CONF

    root = os.path.join(HERE, "build", "interfaces")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    procs = convert_manifests(root)
    try:
        t0 = time.time()
        store, stats, cubes = write_inputs(torch, root)
        log(f"  the {WX_SHAPE[0]}x{WX_SHAPE[1]} zarr store ({WX_TIMES} times, 74 inputs) and "
            f"{GEFS_MEMBERS} GFS cubes ({GFS_SHAPE[0]}x{GFS_SHAPE[1]}, {len(GFS_LEVELS)} "
            f"levels) written in {time.time() - t0:.1f} s while the conversions ran")
        saves = finish_conversions(procs)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    applications_path(torch, runs, root, saves, store, stats, cubes, MANIFEST_MODEL_CONF)
    shutil.rmtree(root, ignore_errors=True)


def tiny_cli(torch) -> None:
    """Phase 3's CLI: `credit_torch.cli.main.main` in this process for init,
    summary, train, rollout, metrics, preprocess, submit and solar on the
    tiny CrossFormer (f32) over a synthetic 32x64 dataset; train and rollout
    on the card and with --device cpu: every training_log.csv cell but
    `seconds` within TINY_FIT_TOL relative, the rollout's files by
    diff_rollout within TINY_FIT_TOL. Optional packages: plot needs
    matplotlib, tune optuna (else it exits 2), reading a credit_tpu
    checkpoint tensorstore; what is absent is said and not run."""
    import io

    from credit_torch.applications import diff_rollout
    from credit_torch.cli.main import main as cli

    root = os.path.join(HERE, "build", "cli_tiny")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(list(argv))
        if rc != 0:
            raise AssertionError(f"credit-torch {' '.join(argv)}: exit {rc}\n{buf.getvalue()}")
        return buf.getvalue()

    data = {**TINY_DATA, "history_len": 1, "forecast_len": 1, "n_times": 12}
    trainer = {"train_batch_size": 1, "num_epoch": 2, "batches_per_epoch": 2,
               "learning_rate": 1e-3, "preflight": False}
    cfgs = {}
    for dev in ("cuda", "cpu"):
        cfgs[dev] = _write_json(os.path.join(root, f"{dev}.json"), {
            "model": TINY, "data": data, "trainer": trainer, "save_loc": os.path.join(root, dev),
            "loss": {"training_loss": "mse"}, "predict": {"forecast_steps": 2}})
    t0 = time.time()
    run("init", os.path.join(root, "template.yml"))
    summary = run("summary", cfgs["cuda"]).strip().splitlines()[-1]
    logs, paths = {}, {}
    for dev in ("cuda", "cpu"):
        run("train", cfgs[dev], "--device", dev)
        logs[dev] = read_log(os.path.join(root, dev))
        paths[dev] = run("rollout", cfgs[dev], "--device", dev).split()
    header = logs["cpu"][0]
    worst = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)
                for grow, crow in zip(logs["cuda"][1:], logs["cpu"][1:])
                for n, a, b in zip(header, grow, crow) if n != "seconds")
    report = diff_rollout(paths["cuda"], os.path.join(root, "cpu", "forecasts"),
                          rtol=TINY_FIT_TOL, atol=TINY_FIT_TOL)
    rworst = max(v["rel"] for r in report for v in r["vars"].values())
    rows = json.loads(run("metrics", cfgs["cuda"], *sorted(paths["cuda"])))
    run("preprocess", cfgs["cuda"], "--samples", "4")
    run("submit", cfgs["cuda"], "--scheduler", "slurm", "--gpus-per-node", "4", "--out",
        os.path.join(root, "launch.sh"))
    solar = json.loads(run("solar", "--nlat", "19", "--nlon", "36", "--out",
                           os.path.join(root, "solar")))
    log(f"  credit-torch CLI in process, tiny CrossFormer f32 ({time.time() - t0:.1f} s): "
        f"init, summary ({summary}), train 2 epochs and rollout 2 steps on the card and with "
        f"--device cpu: worst log cell rel err {worst:.3e}, worst file variable rel err "
        f"{rworst:.3e}, limit {TINY_FIT_TOL:g}; metrics rows {len(rows)}, preprocess, submit, "
        f"solar {solar['files']} files")
    if not (logs["cuda"][0] == header and len(logs["cuda"]) == len(logs["cpu"]) == 3
            and worst <= TINY_FIT_TOL and len(report) == 2 and all(r["ok"] for r in report)
            and len(rows) == 2 and solar["files"] == 5):
        raise AssertionError("the tiny CLI run on the card disagrees with the CPU")
    try:
        import matplotlib  # noqa: F401

        run("plot", sorted(paths["cuda"])[0], "--out", os.path.join(root, "plot.png"))
        log("  plot: written (matplotlib)")
    except ImportError:
        log("  matplotlib is not installed: `credit-torch plot` not run")
    try:
        import optuna  # noqa: F401

        log("  optuna is installed: `credit-torch tune` not run here (a study is a long run)")
    except ImportError:
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli(["tune", cfgs["cuda"]])
        log(f"  optuna is not installed: `credit-torch tune` not run (exits {rc}, as credit-tpu's)")
        if rc != 2:
            raise AssertionError("tune without optuna must exit 2")
    from credit_torch.convert_jax import read_orbax_checkpoint

    try:
        read_orbax_checkpoint(root)
    except ImportError as e:
        if "tensorstore" not in str(e):
            raise
        log("  tensorstore is not installed: credit_tpu (orbax) checkpoints are not read "
            "here (read_orbax_checkpoint raises ImportError naming it)")
    except FileNotFoundError:
        log("  tensorstore is installed: read_orbax_checkpoint refuses a non-checkpoint "
            "directory")
    shutil.rmtree(root, ignore_errors=True)


def fit_times(trainer) -> None:
    """Each epoch's batch assembly (host, producer thread), copy, train
    step and validation times of the trainer's run, and the train steps'
    spread without the run's first (which may meet cold caches)."""

    def fmt(v):
        return "[" + ", ".join(f"{x:.1f}" for x in v) + "]"

    for e in trainer.epoch_timings:
        log(f"  epoch {e['epoch']}: train step ms {fmt(e['train_ms'])}, validation batch ms "
            f"{fmt(e['valid_ms'])}, batch assembly host ms {fmt(e['assemble_ms'])}, copy to the "
            f"card ms {fmt(e['copy_ms'])}")
    steps = [v for e in trainer.epoch_timings for v in e["train_ms"]][1:]
    if steps:
        log(f"  train steps but the run's first: {len(steps)}, ms min {min(steps):.1f} mean "
            f"{sum(steps) / len(steps):.1f} max {max(steps):.1f}")
    rows = read_log(trainer.save_loc)
    wall = {int(r[0]): float(r[3]) * 1e3 for r in rows[1:]}
    for e in trainer.epoch_timings:
        spans = sum(e["train_ms"]) + sum(e["valid_ms"]) + sum(e["copy_ms"])
        host = sum(e["assemble_ms"])
        log(f"  epoch {e['epoch']}: wall {wall[e['epoch']]:.0f} ms; batch assembly {host:.0f} ms "
            f"on the producer thread against {sum(e['train_ms']) + sum(e['valid_ms']):.0f} ms of "
            f"steps; the device spans (steps, validation, copies; gaps inside them included) "
            f"cover {spans / wall[e['epoch']]:.3f} of the wall time")


def profile_steps(torch, what: str, run, args, steps: int) -> float:
    """torch.profiler over run(*args), which takes `steps` steps: device time
    by kernel and the card's idle share of the wall time (profiler overhead
    included), which it returns. The device's activity only: these figures
    need no trace of every host op, which costs the script time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(*args)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # kernels only: an aten op's device time is its kernels' again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    idle = max(0.0, 1 - busy / wall_ms)
    log(f"  profile of {steps} x {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {idle:.3f}")
    groups = {}
    for name, ms, count in rows:
        g = kernel_group(name)
        groups[g] = tuple(a + b for a, b in zip(groups.get(g, (0.0, 0)), (ms, count)))
    for g, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    {ms / steps:9.3f} ms/step {count // steps:5d} calls/step  [{g}]")
    for name, ms, count in rows[:20]:
        log(f"    {ms / steps:9.3f} ms/step {count // steps:5d} calls/step  {name[:110]}")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    path = os.path.join(HERE, "build", f"profile_{what.replace(' ', '_')}.txt")
    with open(path, "w") as f:
        for name, ms, count in rows:
            f.write(f"{ms / steps:9.3f}\t{count // steps}\t{kernel_group(name)}\t{name}\n")
    log(f"    (every kernel: {os.path.relpath(path, HERE)})")
    return idle


def kernel_group(name: str) -> str:
    """A profile row's kind: one of the port's kernels, a library GEMM, or
    PyTorch glue by operation."""
    port = {"ffb::": "port fused_ff_bwd", "ff::fused": "port fused_ff: fused kernel",
            "ff::": "port fused_ff: split route and row passes", "wgrad::": "port conv2d_wgrad",
            "conv::": "port conv2d_valid", "attn::": "port fused_window_attention",
            "band::": "port conv_band", "copy::": "port copy"}
    for key, group in port.items():
        if f"credit::{key}" in name:
            return group
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass", "gemv", "dot_kernel")):
        return "library GEMM"
    for key, group in [("layer_norm", "glue: layer norm"), ("copy", "glue: copies and casts"),
                       ("Cat", "glue: copies and casts"), ("Memcpy", "glue: copies and casts"),
                       ("reduce", "glue: reductions"), ("softmax", "glue: softmax")]:
        if key in name:
            return group
    return "glue: elementwise"


def step_time(root: str, model: str, steps: int) -> dict:
    """In this process: `root`'s package (its own `chip_smoke` configs),
    phase 18(e)'s unsharded f32 step of `model` ("unet" or "graph"),
    seeded as `_par_step` seeds it: ms of each step after a warm-up one
    (CUDA events) and the peak."""
    sys.path.insert(0, root)
    import importlib

    import torch

    from credit_torch.convert_jax import seed_train_
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.models import load_model
    from credit_torch.tools import cuda_ms
    from credit_torch.trainers.scheduler import load_scheduler
    from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step

    cs = importlib.import_module("chip_smoke")  # the root's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = cs._par_conf((1, 1, 1), {"unet": cs.CONF_UNET_025, "graph": cs.CONF_GRAPH_1DEG}[model])
    mconf, schema = conf["model"], ChannelSchema.from_config(conf)
    net = load_model(conf, device="cuda", sn_state=True)
    seed_train_(net, conf, torch.Generator().manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(5)
    h, w = mconf["image_height"], mconf["image_width"]
    batch = {"x": torch.randn((1, mconf.get("frames", 1), h, w, schema.n_input), generator=g,
                              device="cuda"),
             "y": torch.randn((1, 1, h, w, schema.n_target), generator=g, device="cuda")}
    opt = make_optimizer(conf, load_scheduler(conf))
    step = make_train_step(net, lambda y, p: torch.mean((p.float() - y) ** 2), opt, schema,
                           device="cuda")
    state = TrainState.create(net, opt)
    torch.cuda.reset_peak_memory_stats()
    ms = [cuda_ms(lambda: step(state, batch), 1, warmup=int(i == 0)) for i in range(steps)]
    return {"root": root, "ms": ms, "peak": torch.cuda.max_memory_allocated()}


def compare_steps(model: str, roots: list, steps: int) -> int:
    """`step_time` of each root in a process of its own, A B B A, printed
    after the card's name and power limit."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    roots = [os.path.abspath(r) for r in roots]
    for root in roots + roots[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--step-time-root",
                              root, "--compare-steps", model, "--steps", str(steps)],
                             capture_output=True, text=True, cwd=root)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        r = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{r['root']}: {model} f32 train step ms {[round(v, 3) for v in r['ms']]}, peak "
              f"{r['peak']} bytes ({r['peak'] / 2**30:.3f} GiB)", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true", help="print nvcc's -Xptxas -v report")
    ap.add_argument("--profile", action="store_true",
                    help="after main paths 1-5, profile a 2-step rollout / a training step "
                         "by kernel (main path 7's resumed epoch is profiled in every run)")
    ap.add_argument("--parallel-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--compare-steps", nargs="+", metavar=("MODEL", "ROOT"), default=None,
                    help="only time the unsharded unet or graph step of each ROOT, A B B A")
    ap.add_argument("--steps", type=int, default=5, help="steps a root for --compare-steps")
    ap.add_argument("--step-time-root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.step_time_root is not None:  # one root of --compare-steps
        print(json.dumps(step_time(args.step_time_root, args.compare_steps[0], args.steps)))
        return 0
    if args.compare_steps is not None:
        if len(args.compare_steps) < 2 or args.compare_steps[0] not in ("unet", "graph"):
            ap.error("--compare-steps takes unet or graph, then one ROOT or more")
        return compare_steps(args.compare_steps[0], args.compare_steps[1:], args.steps)
    if args.parallel_rank is not None:  # one rank of phase 18, started by the phase
        return parallel_rank(args.parallel_rank, 2, args.parallel_dir)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from credit_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    log(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi)

    log("phase 1: build")
    t0 = time.time()
    _build.build(verbose=args.ptxas)
    _build.library()
    log(f"  built {[p.name for p in _build.sources()]} in {time.time() - t0:.1f} s")

    log("phase 2: kernels against their plain versions (tolerance relative to max |plain|)")
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        conv = conv_cases(torch, g)
        ff = ff_cases(torch, g)
        attn = attention_cases(torch, g)
        ff_bwd = ff_bwd_cases(torch, g)
        ff_tp = ff_tp_cases(torch, g)
        wgrad = wgrad_cases(torch, g)
        probe = probe_cases(torch, g)
    torch.cuda.empty_cache()

    log("phase 3: tiny models on the card against the CPU")
    before = torch.cuda.memory_allocated()
    tiny_agreement(torch, TINY, TINY_DATA)
    log("  tiny FuXi, two input frames:")
    tiny_agreement(torch, TINY_FUXI, TINY_FUXI_DATA)
    tiny_post_rollout(torch)
    tiny_fit(torch)
    tiny_ensemble(torch)
    log("  the model zoo (every type beyond the CrossFormer, FuXi and the ensemble):")
    tiny_zoo(torch)
    tiny_cli(torch)
    log(f"  allocated on the card: {before} bytes before phase 3, "
        f"{torch.cuda.memory_allocated()} after it")
    runs, times = {}, {}
    fwd_025, fwd_fuxi = expected_per_step(CONF_025), expected_fuxi_per_step(CONF_FUXI)
    log("phase 4: main path 1, CONF_025 bf16 rollout")
    runs["rollout_025"] = rollout_path(torch, "CONF_025", CONF_025, DATA_025, fwd_025,
                                       args.profile, times)
    torch.cuda.empty_cache()
    log("phase 5: main path 2, CONF_025 training step")
    runs["train_025"] = train_path(torch, "CONF_025", CONF_025_TRAIN, DATA_025,
                                   expected_train_per_step(fwd_025, False), args.profile)
    torch.cuda.empty_cache()
    log("phase 6: main path 3, CONF_FUXI bf16 rollout (two input frames)")
    runs["rollout_fuxi"] = rollout_path(torch, "CONF_FUXI", CONF_FUXI, DATA_FUXI, fwd_fuxi,
                                        args.profile)
    torch.cuda.empty_cache()
    log("phase 7: main path 4, CONF_FUXI training step (two input frames)")
    runs["train_fuxi"] = train_path(torch, "CONF_FUXI", CONF_FUXI, DATA_FUXI,
                                    expected_train_per_step(fwd_fuxi, True), args.profile)
    torch.cuda.empty_cache()
    log("phase 8: main path 5, CONF_025_POST: RolloutEngine with the Normalizer and the fixers")
    runs["post_025"] = post_path(torch, expected_per_step(CONF_025_TRAIN), times, args.profile)
    torch.cuda.empty_cache()
    log("phase 9: main path 6, the tool benches (credit_torch.tools)")
    runs["tools"] = tools_path(torch)
    torch.cuda.empty_cache()
    log("phase 10: main path 7, credit train at CONF_025 (run_training on a zarr ERA5 store)")
    runs["fit_025"], store = fit_path(torch, expected_train_per_step(fwd_025, False),
                                      expected_per_step(CONF_025_TRAIN))
    torch.cuda.empty_cache()
    log("phase 11: main path 8, ensemble CRPS training at CONF_025 width (crossformer-ensemble, "
        "2 members, grad_accum_every 2, sn_external)")
    runs["fit_ens_025"] = ensemble_fit_path(torch, store, expected_train_per_step(fwd_025, False),
                                            expected_per_step(CONF_025_TRAIN))
    torch.cuda.empty_cache()
    log("phase 12: main path 9, credit rollout at CONF_025 width (run_rollout to netCDF from "
        "phase 10's checkpoint and store)")
    runs["rollout_nc"], forecast = rollout_nc_path(torch, store,
                                                   expected_per_step(CONF_025_TRAIN))
    torch.cuda.empty_cache()
    log("phase 13: main path 10, credit train at CONF_025 on computed solar forcing (a tisr "
        "source); the regrid preblock, the SHT and the granule readers at full size")
    runs["fit_tisr_025"] = tisr_fit_path(torch, store, expected_train_per_step(fwd_025, False),
                                         expected_per_step(CONF_025_TRAIN))
    torch.cuda.empty_cache()
    regrid_phase(torch)
    sht_phase(torch, forecast)
    granule_phase()
    torch.cuda.empty_cache()
    log("phase 14: main path 11, the SKEBS ensemble at CONF_025 width: run_training with SKEBS "
        "and a learned backscatter net, run_rollout with the pattern carried, the physics blocks "
        "at full size")
    t14 = time.time()
    step_025 = expected_per_step(CONF_025_TRAIN)
    runs["skebs_ens_025"], skebs_conf = skebs_fit_path(
        torch, store, skebs_net_launches(expected_train_per_step(fwd_025, False), True),
        skebs_net_launches(step_025, False))
    torch.cuda.empty_cache()
    runs["skebs_rollout_025"], last = skebs_rollout_path(torch, store, skebs_conf,
                                                         skebs_net_launches(step_025, False))
    torch.cuda.empty_cache()
    physics_phase(torch, last)
    del last
    torch.cuda.empty_cache()
    log(f"  phase 14: {time.time() - t14:.1f} s")
    log("phase 15: main path 12, NextGen WXFormer at CONF_025 width (run_training, checkpoint "
        "read back, bf16 rollout); camulator with the sub-pixel decoder beside it")
    t15 = time.time()
    nextgen_path(torch, store, runs)
    torch.cuda.empty_cache()
    log(f"  phase 15: {time.time() - t15:.1f} s")
    log("phase 16: main path 13, era5-diffusion with crossformer-diffusion at CONF_025 width "
        "(DDIM validation)")
    t16 = time.time()
    diffusion_path(torch, store, runs)
    torch.cuda.empty_cache()
    log(f"  phase 16: {time.time() - t16:.1f} s")
    log("phase 17: main path 14, ensemble forecasts and their verification at CONF_025 width "
        "(run_rollout with ensemble_size > 1, rollout_metrics, ensemble_eval, ic-opt, ptype, the "
        "SDL wrapper)")
    t17 = time.time()
    ensemble_path(torch, store, runs)
    torch.cuda.empty_cache()
    log(f"  phase 17: {time.time() - t17:.1f} s")
    log("phase 18: main path 15, parallelism on the one card (run_training over NCCL at world "
        "size 1; two ranks over gloo at domain 2, at data 2 and at tensor 2; ring-CRPS; NextGen, "
        "the U-Net and the graph at domain 2)")
    t18 = time.time()
    parallel_path(torch, store, runs, expected_train_per_step(fwd_025, False),
                  expected_per_step(CONF_025_TRAIN))
    torch.cuda.empty_cache()
    log(f"  phase 18: {time.time() - t18:.1f} s")
    shutil.rmtree(os.path.dirname(store[0]), ignore_errors=True)
    log("phase 19: main path 16, the applications and interfaces (the published wxformer_6h "
        "and fuxi_6h layouts converted, credit-torch realtime from a GFS cube, credit-torch "
        "serve, a FuXi step)")
    t19 = time.time()
    interfaces_path(torch, runs)
    torch.cuda.empty_cache()
    log(f"  phase 19: {time.time() - t19:.1f} s")

    kernels = []
    # main paths 12 and 13 (phases 15 and 16)
    ZOO_PATHS = ("fit_nextgen", "rollout_nextgen", "train_camulator_ps", "rollout_camulator_ps",
                 "fit_diffusion")
    # main path 14 (phase 17)
    ENS_PATHS = ("ens_rollout", "ens_rollout_bred", "ens_metrics", "ens_metrics_bred", "icopt",
                 "sdl_025")
    # main path 15 (phase 18): all train steps
    PAR_PATHS = ("par_fit_nccl", "par_domain2", "par_ens_domain2", "par_dp2", "par_tp2",
                 "par_ng_domain2")
    # main path 16 (phase 19): the converted wxformer_6h's forecasts
    APP_PATHS = ("rt_wx", "rt_gefs", "serve_wx")
    for name, counter, src, replaces, r, paths in [
            ("conv2d_valid", "conv2d_valid_bf16", "credit_torch/csrc/conv_valid.cu",
             "credit_tpu/ops/pallas_conv.py:110", conv[("stage0_embed_8x8", torch.bfloat16)],
             runs),
            ("fused_ff", "fused_ff_fused", "credit_torch/csrc/fused_ff.cu",
             "credit_tpu/ops/pallas_ff.py:475", ff[("stage0_C128", torch.bfloat16)],
             ("rollout_025", "train_025", "post_025", "tools", "fit_025", "fit_ens_025",
              "rollout_nc", "fit_tisr_025", "skebs_ens_025", "skebs_rollout_025", *ZOO_PATHS,
              *ENS_PATHS, *PAR_PATHS, *APP_PATHS)),
            ("fused_ff split pre-norm", "fused_ff_split", "credit_torch/csrc/fused_ff.cu",
             "credit_tpu/ops/pallas_ff.py:475", ff[("stage2_C512", torch.bfloat16)],
             ("rollout_025", "train_025", "post_025", "fit_025", "fit_ens_025", "rollout_nc",
              "fit_tisr_025", "skebs_ens_025", "skebs_rollout_025", *ZOO_PATHS, *ENS_PATHS,
              *PAR_PATHS, *APP_PATHS)),
            ("fused_ff split post-norm", "fused_ff_split", "credit_torch/csrc/fused_ff.cu",
             "credit_tpu/ops/pallas_ff.py:475", ff[("fuxi_C1024_post", torch.bfloat16)],
             ("rollout_fuxi", "train_fuxi", "fx_6h")),
            ("fused_window_attention", "fused_window_attention",
             "credit_torch/csrc/window_attention.cu", "credit_tpu/ops/pallas_attention.py:75",
             attn, ("rollout_025", "train_025", "post_025", "fit_025", "fit_ens_025",
                    "rollout_nc", "fit_tisr_025", "skebs_ens_025", "skebs_rollout_025",
                    *ZOO_PATHS, *ENS_PATHS, *PAR_PATHS, *APP_PATHS)),
            ("fused_ff_bwd pre-norm", "fused_ff_bwd", "credit_torch/csrc/fused_ff_bwd.cu",
             "credit_tpu/ops/pallas_ff.py:346", ff_bwd[("stage0_C128", torch.bfloat16)],
             ("train_025", "fit_025", "fit_ens_025", "fit_tisr_025", "skebs_ens_025",
              "fit_nextgen", "train_camulator_ps", "fit_diffusion", "icopt", *PAR_PATHS)),
            ("fused_ff_bwd post-norm", "fused_ff_bwd", "credit_torch/csrc/fused_ff_bwd.cu",
             "credit_tpu/ops/pallas_ff.py:346", ff_bwd[("fuxi_C1024_post", torch.bfloat16)],
             ("train_fuxi",)),
            ("fused_ff tp ff_partial pre-norm", "ff_partial", "credit_torch/csrc/fused_ff.cu",
             "credit_tpu/ops/pallas_ff.py:475",
             ff_tp[("ff_partial", "tp2_stage0_C128", torch.bfloat16)], ("par_tp2",)),
            ("fused_ff tp ff_partial post-norm", "ff_partial", "credit_torch/csrc/fused_ff.cu",
             "credit_tpu/ops/pallas_ff.py:475",
             ff_tp[("ff_partial", "tp2_fuxi_C1024_post", torch.bfloat16)], ("par_fuxi_tp2",)),
            ("fused_ff tp ff_finish pre-norm", "ff_finish", "credit_torch/csrc/fused_ff.cu",
             "credit_tpu/ops/pallas_ff.py:475",
             ff_tp[("ff_finish", "tp2_stage0_C128", torch.bfloat16)], ("par_tp2",)),
            ("fused_ff tp ff_finish post-norm", "ff_finish", "credit_torch/csrc/fused_ff.cu",
             "credit_tpu/ops/pallas_ff.py:475",
             ff_tp[("ff_finish", "tp2_fuxi_C1024_post", torch.bfloat16)], ("par_fuxi_tp2",)),
            ("fused_ff_bwd tp ff_partial_bwd pre-norm", "ff_partial_bwd",
             "credit_torch/csrc/fused_ff_bwd.cu", "credit_tpu/ops/pallas_ff.py:346",
             ff_tp[("ff_partial_bwd", "tp2_stage0_C128", torch.bfloat16)], ("par_tp2",)),
            ("fused_ff_bwd tp ff_partial_bwd post-norm", "ff_partial_bwd",
             "credit_torch/csrc/fused_ff_bwd.cu", "credit_tpu/ops/pallas_ff.py:346",
             ff_tp[("ff_partial_bwd", "tp2_fuxi_C1024_post", torch.bfloat16)],
             ("par_fuxi_tp2",)),
            ("fused_ff_bwd tp ff_finish_bwd pre-norm", "ff_finish_bwd",
             "credit_torch/csrc/fused_ff_bwd.cu", "credit_tpu/ops/pallas_ff.py:346",
             ff_tp[("ff_finish_bwd", "tp2_stage0_C128", torch.bfloat16)], ("par_tp2",)),
            ("fused_ff_bwd tp ff_finish_bwd post-norm", "ff_finish_bwd",
             "credit_torch/csrc/fused_ff_bwd.cu", "credit_tpu/ops/pallas_ff.py:346",
             ff_tp[("ff_finish_bwd", "tp2_fuxi_C1024_post", torch.bfloat16)],
             ("par_fuxi_tp2",)),
            ("conv2d_wgrad", "conv2d_wgrad_bf16", "credit_torch/csrc/conv_wgrad.cu",
             "credit_tpu/ops/pallas_conv.py:245", wgrad[("stage0_embed_8x8", torch.bfloat16)],
             runs),
            # the f32 forms (3xTF32): the U-Net family and SKEBS's cnn
            ("conv2d_valid f32", "conv2d_valid_f32", "credit_torch/csrc/conv_valid.cu",
             "credit_tpu/ops/pallas_conv.py:110",
             conv[("unet_l0_64to64_3x3", torch.float32)], runs),
            ("conv2d_wgrad f32", "conv2d_wgrad_f32", "credit_torch/csrc/conv_wgrad.cu",
             "credit_tpu/ops/pallas_conv.py:245",
             wgrad[("unet_l0_64to64_3x3", torch.float32)], runs),
            ("conv_band dma", "conv_band_dma", "credit_torch/csrc/conv_band.cu",
             "tools/bench_pallas_conv.py:60", probe[("dma", torch.bfloat16)], ("tools",)),
            ("conv_band halo", "conv_band_halo", "credit_torch/csrc/conv_band.cu",
             "tools/bench_pallas_conv.py:123", probe[("halo", torch.bfloat16)], ("tools",)),
            ("copy", "copy", "credit_torch/csrc/copy.cu", "tools/bench_conv_ffk.py:75",
             probe["copy"], ("tools",))]:
        # launches: the main-path runs of this kernel (mode); each path runs
        # one FF form only, so a path's count is the mode's; the fused FF
        # kernel's are the FF calls the split route did not take, and
        # kernels 2 and 5's bf16 form's the launches that were not f32
        by_path = {p: (runs[p]["fused_ff"] - runs[p]["fused_ff_split"]
                       if counter == "fused_ff_fused" else
                       runs[p][counter[:-5]] - runs[p].get(counter[:-5] + "_f32", 0)
                       if counter.endswith("_bf16") else runs[p].get(counter, 0))
                   for p in paths}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path, **r})
        if name == "fused_ff":
            kernels[-1]["design"] = (
                "bf16 C <= 256: persistent blocks, a TMA producer warp and 64-row consumer "
                "warpgroups (three up to C = 128, two at 256) on wgmma; per 64-column hidden "
                "chunk fc1's f32 accumulators take b1 and the exact GELU in registers and, "
                "packed to bf16, are fc2's A operand (the hidden layer never leaves the "
                "registers); LN, post-norm LN and the residual in the warpgroups, a TMA store")
    log(f"chip_smoke: {time.time() - T_START:.1f} s end to end")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

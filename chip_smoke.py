#!/usr/bin/env python3
"""Smoke test of the PyTorch port (credit_torch) on one CUDA card.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --ptxas      # also print nvcc's register/smem report
    python3 chip_smoke.py --profile    # also by-kernel profiles of main paths 1-5
                                       # (every row in build/profile_*.txt)

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
     its weight gradient at every shape the paths launch, up to 16x16 taps,
     with channels the wrapper pads and a kernel taller than wide (the
     weight gradient also bit-identical on a second call, as is the FF
     backward in bf16, timed beside PyTorch's autograd of its composition),
     the tools' row-band conv drafts and copy, with the error beside its
     limit and the kernel's, the plain version's and a library call's times;
  3. a tiny CrossFormer and a tiny FuXi (two input frames), each with a
     2-step rollout and a training step, on the card against the same model
     on the CPU (plain versions), and each train-mode backward with bf16
     compute on the card against f32 on the CPU; the tiny CrossFormer's
     RolloutEngine with a Normalizer and the four fixers likewise;
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
     every step against its limit;
  9. main path 6, the tool benches: credit_torch.tools.bench_conv (cuDNN,
     kernel 2 and the two row-band drafts) and bench_conv_ffk (the 32x32/s2
     conv + 4 FFs in five modes) at full size, launches counted per call.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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

# published dense peaks of one H100 SXM at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# bf16 train-mode loss, gradients by norm and worst parameter of the tiny
# models against f32, relative: a few times above the readings (bf16
# rounding, not summation order) -- the CrossFormer's on the card (1.63e-4,
# 1.35e-2, 6.5e-2), FuXi's with the plain versions in bf16 on a CPU
# (6.4e-4, 2.7e-2, 2.1e-2)
BF16_TRAIN_LIMITS = {"crossformer": (1e-3, 5e-2, 0.25), "fuxi": (3e-3, 0.1, 0.25)}

ROLLOUT_STEPS = 3
# rollouts timed again after the counted one, for the spread: the host sets
# the WXFormer's step time, and one timed rollout read from 42.7 to 92.0
# ms/step on one H100 80GB HBM3 at 700 W from call to call (PERF.md)
ROLLOUT_REPEATS = 3
TRAIN_STEPS = 3
POST_STEPS = 3
# bench_conv_ffk's modes in phase 9: the plain FFs, the kernel's, and the
# three identity copies
FFK_MODES = ("xla", "pallas", "identity", "identity-input", "identity-end")
# the JAX training bench's configuration (bench.py:557-630): CONF_025 with
# output_only_channels raised so that the outputs cover the 8 diagnostic
# targets (64 outputs, a 256 -> 256 head phase conv), forecast_len 1, batch 1
CONF_025_TRAIN = {**CONF_025, "output_only_channels": 8}
TRAINER = {"learning_rate": 1e-4}

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


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_case(name, dtype, kernel_fn, plain_fn, library_fn, nbytes, flops, tol, iters):
    """Compare a kernel with its plain version on the same inputs; time all
    three. tol is relative to max |plain|, for each output of a kernel that
    returns several (the printed error and limit are the worst output's)."""
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
    b_ms, b_by = bound(nbytes, flops, dtype)
    log(f"  {name} [{dtype}] max_abs_err {err:.3e} limit {limit:.3e} (={tol:g} x max|ref| "
        f"{scale:.3e}) ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms {b_ms:.4f} ({b_by})"
        f"{'' if ok else '  FAIL'}")
    if not ok:
        raise AssertionError(f"{name} [{dtype}]: kernel disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


# kernel 2's shapes (n, hp, wp, cin, kh, kw, cout) with the dtypes checked.
# WXFormer: the stage-0 quadrant embed after space-to-depth; the final 3x3
# phase conv of the ConvTranspose head (ragged: 402x722 input, 224
# outputs); the stage 1-3 embeds (2x2 after space-to-depth) and the
# UpBlocks' 3x3 residual convs. FuXi: the DownBlock's 3x3/s2 conv after its
# zero-extension to 4x4 and space-to-depth (2x2 over 4096 channels, 7 of 16
# taps zero), its 3x3 residual convs at 100x160 and the UpBlock's at
# 200x320. The conv bench's 32x32/s2 embed is a 16x16 conv. Beyond the
# paths: channels that are not multiples of 8 (the wrapper pads them) and
# a kernel taller than wide
BF16, BOTH = ("bfloat16",), ("bfloat16", "float32")
CONV_SHAPES = [
    ("stage0_embed_8x8", (1, 415, 735, 240, 8, 8, 176), BOTH, 10),
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
    ("ragged_channels_3x3", (1, 130, 250, 100, 3, 3, 60), BF16, 10),
    ("tall_3x2", (1, 130, 250, 128, 3, 2, 128), BF16, 10)]


def conv_cases(torch, g):
    import torch.nn.functional as F

    from credit_torch.ops import cuda_conv

    res = {}
    for label, (n, hp, wp, cin, kh, kw, cout), dtypes, iters in CONV_SHAPES:
        # f32: the kernel sums the kh*kw*cin products of an output one after
        # another, and that sum's rounding grows as their count's square
        # root (a random walk): the 8x8 (15,360 products) read 5.2e-6 of
        # max |plain|, the 16x16 (61,440) 1.03e-5, twice as much, and the
        # same against f64 sums, where the plain version's GEMMs read
        # <= 1.7e-6. So the limit grows with that root beyond the 8x8's
        # 15,360 products, keeping the 8x8's margin of about 2
        f32_tol = 1e-5 * math.sqrt(max(1.0, kh * kw * cin / 15360))
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
                           2.0 * n * ho * wo * kh * kw * cin * cout, tol, iters)
            res[(label, dt)] = r
            if dt == torch.float32:
                # whose rounding the difference is: both against f64 sums
                exact = conv_valid_f64(torch, x, k)
                sc = exact.abs().max().item()
                e_k, e_p = ((f(x, k).double() - exact).abs().max().item() / sc
                            for f in (cuda_conv.conv2d_valid, cuda_conv.conv2d_valid_plain))
                log(f"    against f64 sums, of max |ref|: kernel {e_k:.3e}, plain {e_p:.3e}")
                del exact
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


# (label, (h, w, C), post-norm, hidden) of the FF and its backward
FF_SHAPES = [("stage0_C128", (400, 720, 128), False, 512),
             ("stage1_C256", (200, 360, 256), False, 1024),
             ("stage2_C512", (100, 180, 512), False, 2048),
             ("stage3_C1024", (50, 90, 1024), False, 4096),
             ("fuxi_C1024_post", (105, 161, 1024), True, 4096),
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
# three conv shapes), and the ragged and tall cases of CONV_SHAPES
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
    ("ragged_channels_3x3", (1, 130, 250, 100, 3, 3, 60), BF16, 5),
    ("tall_3x2", (1, 130, 250, 128, 3, 2, 128), BF16, 5)]


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
                           2.0 * n * ho * wo * kh * kw * cin * cout, tol, iters)
            if not torch.equal(cuda_conv.conv2d_wgrad(x, gy, kh, kw),
                               cuda_conv.conv2d_wgrad(x, gy, kh, kw)):
                raise AssertionError(f"conv2d_wgrad {label} [{name}]: two calls differ")
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
            ("conv2d_wgrad", cuda_conv.conv2d_wgrad, "launches"),
            ("conv_band_dma", cuda_probes.conv_band_dma, "launches"),
            ("conv_band_halo", cuda_probes.conv_band_halo, "launches"),
            ("copy", cuda_probes.copy, "launches")]


def _zero_counts() -> None:
    for _, wrapper, attr in _counters():
        setattr(wrapper, attr, 0)


def _read_counts() -> dict:
    return {name: getattr(wrapper, attr) for name, wrapper, attr in _counters()}


def _check_counts(counts: dict, want: dict, steps: int) -> None:
    for k in counts:
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
    log(f"  CONF_025_POST RolloutEngine {POST_STEPS} steps: {ms:.1f} ms/step (phase 4's "
        f"make_scan_rollout: {ref_ms:.1f} ms/step), peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB; {base} allocated before it), launches {counts}")
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
                 profile: bool = False, times: dict = None) -> dict:
    """A bf16 forecast of `model_conf` on seeded folded weights at batch 1:
    a warm-up step, then ROLLOUT_STEPS steps whose kernel launches are
    counted and checked against `want` per step, then ROLLOUT_REPEATS more
    such rollouts timed for the spread; returns the counts and puts the
    first rollout's ms/step into `times[name]`."""
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

    run = make_scan_rollout(model, schema, ROLLOUT_STEPS, history_len=frames, device="cuda")
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
        times[name] = elapsed * 1e3 / ROLLOUT_STEPS
    log(f"  {name} rollout {ROLLOUT_STEPS} steps: {elapsed * 1e3 / ROLLOUT_STEPS:.1f} ms/step, "
        f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB; {base} allocated before it), "
        f"launches {counts}")
    _check_counts(counts, want, ROLLOUT_STEPS)
    if final_x.shape != x0.shape or stats.shape != (ROLLOUT_STEPS, model.base_output_channels):
        raise AssertionError((tuple(final_x.shape), tuple(stats.shape)))
    fin = torch.isfinite(final_x).all().item() and torch.isfinite(stats).all().item()
    amax = final_x.float().abs().max().item()
    log(f"  final state finite: {fin}, max |x| {amax:.3e}; per-step channel means "
        f"range [{stats.float().min().item():.3e}, {stats.float().max().item():.3e}]")
    if not fin:
        raise AssertionError("rollout produced non-finite values")
    spread = []
    for _ in range(ROLLOUT_REPEATS):
        torch.cuda.synchronize()
        t0 = time.time()
        run(x0)
        torch.cuda.synchronize()
        spread.append((time.time() - t0) * 1e3 / ROLLOUT_STEPS)
    log(f"  {ROLLOUT_REPEATS} more rollouts of {ROLLOUT_STEPS} steps: "
        + ", ".join(f"{v:.1f}" for v in spread) + " ms/step")
    if profile:
        profile_steps(torch, f"{name} rollout step",
                      make_scan_rollout(model, schema, 2, history_len=frames, device="cuda"),
                      (x0,), steps=2)
    return counts


def train_path(torch, name: str, model_conf: dict, data: dict, want: dict,
               profile: bool = False) -> dict:
    """TRAIN_STEPS training steps of `model_conf` (seeded f32 weights with
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
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, norms = [float(v) for v in losses], [float(v) for v in norms]
    log(f"  {name} training step: {elapsed * 1e3 / TRAIN_STEPS:.1f} ms/step over "
        f"{TRAIN_STEPS} steps, peak memory {peak} bytes ({peak / 2**30:.2f} GiB; {base} "
        f"allocated before it), launches {counts}")
    log(f"  losses {losses}, grad norms {norms}")
    _check_counts(counts, want, TRAIN_STEPS)
    if not all(math.isfinite(v) for v in losses + norms) or state.step != TRAIN_STEPS + 1:
        raise AssertionError("training produced a non-finite loss or gradient norm")
    if profile:
        profile_steps(torch, f"{name} training step", lambda b: step(state, b), (batch,),
                      steps=1)
    return counts


def profile_steps(torch, what: str, run, args, steps: int) -> None:
    """torch.profiler over run(*args), which takes `steps` steps: device time
    by kernel and the card's idle share of the wall time (profiler overhead
    included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(*args)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # kernels only: an aten op's device time is its kernels' again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"  profile of {steps} x {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true", help="print nvcc's -Xptxas -v report")
    ap.add_argument("--profile", action="store_true",
                    help="after main paths 1-5, profile a 2-step rollout / a training step "
                         "by kernel")
    args = ap.parse_args()
    t_start = time.time()

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
        wgrad = wgrad_cases(torch, g)
        probe = probe_cases(torch, g)
    torch.cuda.empty_cache()

    log("phase 3: tiny models on the card against the CPU")
    before = torch.cuda.memory_allocated()
    tiny_agreement(torch, TINY, TINY_DATA)
    log("  tiny FuXi, two input frames:")
    tiny_agreement(torch, TINY_FUXI, TINY_FUXI_DATA)
    tiny_post_rollout(torch)
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

    kernels = []
    for name, counter, src, replaces, r, paths in [
            ("conv2d_valid", "conv2d_valid", "credit_torch/csrc/conv_valid.cu",
             "credit_tpu/ops/pallas_conv.py:110", conv[("stage0_embed_8x8", torch.bfloat16)],
             runs),
            ("fused_ff", "fused_ff_fused", "credit_torch/csrc/fused_ff.cu",
             "credit_tpu/ops/pallas_ff.py:475", ff[("stage0_C128", torch.bfloat16)],
             ("rollout_025", "train_025", "post_025", "tools")),
            ("fused_ff split pre-norm", "fused_ff_split", "credit_torch/csrc/fused_ff.cu",
             "credit_tpu/ops/pallas_ff.py:475", ff[("stage2_C512", torch.bfloat16)],
             ("rollout_025", "train_025", "post_025")),
            ("fused_ff split post-norm", "fused_ff_split", "credit_torch/csrc/fused_ff.cu",
             "credit_tpu/ops/pallas_ff.py:475", ff[("fuxi_C1024_post", torch.bfloat16)],
             ("rollout_fuxi", "train_fuxi")),
            ("fused_window_attention", "fused_window_attention",
             "credit_torch/csrc/window_attention.cu", "credit_tpu/ops/pallas_attention.py:75",
             attn, ("rollout_025", "train_025", "post_025")),
            ("fused_ff_bwd pre-norm", "fused_ff_bwd", "credit_torch/csrc/fused_ff_bwd.cu",
             "credit_tpu/ops/pallas_ff.py:346", ff_bwd[("stage0_C128", torch.bfloat16)],
             ("train_025",)),
            ("fused_ff_bwd post-norm", "fused_ff_bwd", "credit_torch/csrc/fused_ff_bwd.cu",
             "credit_tpu/ops/pallas_ff.py:346", ff_bwd[("fuxi_C1024_post", torch.bfloat16)],
             ("train_fuxi",)),
            ("conv2d_wgrad", "conv2d_wgrad", "credit_torch/csrc/conv_wgrad.cu",
             "credit_tpu/ops/pallas_conv.py:245", wgrad[("stage0_embed_8x8", torch.bfloat16)],
             runs),
            ("conv_band dma", "conv_band_dma", "credit_torch/csrc/conv_band.cu",
             "tools/bench_pallas_conv.py:60", probe[("dma", torch.bfloat16)], ("tools",)),
            ("conv_band halo", "conv_band_halo", "credit_torch/csrc/conv_band.cu",
             "tools/bench_pallas_conv.py:123", probe[("halo", torch.bfloat16)], ("tools",)),
            ("copy", "copy", "credit_torch/csrc/copy.cu", "tools/bench_conv_ffk.py:75",
             probe["copy"], ("tools",))]:
        # launches: the main-path runs of this kernel (mode); each path runs
        # one FF form only, so a path's count is the mode's; the fused FF
        # kernel's are the FF calls the split route did not take
        by_path = {p: runs[p]["fused_ff"] - runs[p]["fused_ff_split"] if counter == "fused_ff_fused"
                   else runs[p][counter] for p in paths}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path, **r})
        if name == "fused_ff":
            kernels[-1]["design"] = (
                "bf16 C <= 256: persistent blocks, a TMA producer warp and 64-row consumer "
                "warpgroups (three up to C = 128, two at 256) on wgmma; per 64-column hidden "
                "chunk fc1's f32 accumulators take b1 and the exact GELU in registers and, "
                "packed to bf16, are fc2's A operand (the hidden layer never leaves the "
                "registers); LN, post-norm LN and the residual in the warpgroups, a TMA store")
    log(f"chip_smoke: {time.time() - t_start:.1f} s end to end")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

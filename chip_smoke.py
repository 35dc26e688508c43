#!/usr/bin/env python3
"""Smoke test of the PyTorch port (credit_torch) on one CUDA card.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --ptxas      # also print nvcc's register/smem report
    python3 chip_smoke.py --profile    # also a by-kernel profile of the rollout

Phases (any failure exits non-zero):
  1. build the kernels from credit_torch/csrc with nvcc (printed seconds);
  2. hold each kernel against its plain PyTorch version on the card, at
     flagship shapes in bf16 and f32 (TF32 off), with the error beside its
     limit and the kernel's, the plain version's and a library call's times;
  3. a tiny CrossFormer and a 2-step rollout on the card against the same
     model on the CPU (plain versions);
  4. the main path: the 0.25-degree WXFormer (CONF_025 below) with seeded
     folded weights in bf16 at batch 1, a warm-up step, then a rollout whose
     kernel launches are counted and checked against the config.
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

# published dense peaks of one H100 SXM at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

ROLLOUT_STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_case(name, dtype, kernel_fn, plain_fn, library_fn, nbytes, flops, tol, iters):
    """Compare a kernel with its plain version on the same inputs; time all
    three. tol is relative to max |plain|."""
    import torch

    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    limit = tol * scale
    ok = math.isfinite(err) and err <= limit
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


def conv_cases(torch, g):
    import torch.nn.functional as F

    from credit_torch.ops import cuda_conv

    res = {}
    # stage-0 quadrant embed after space-to-depth; the final 3x3 phase conv
    # of the ConvTranspose head (ragged: 402x722 input, 224 outputs)
    for label, (n, hp, wp, cin, kh, cout) in [("stage0_embed_8x8", (1, 415, 735, 240, 8, 176)),
                                              ("head_phase_3x3", (1, 402, 722, 256, 3, 224))]:
        for dt, tol in [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)]:
            x = (torch.randn((n, hp, wp, cin), generator=g, device="cuda") * 0.5).to(dt)
            k = (torch.randn((kh, kh, cin, cout), generator=g, device="cuda")
                 / math.sqrt(kh * kh * cin)).to(dt)
            xn = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
            kn = k.permute(3, 2, 0, 1).contiguous()
            ho, wo = hp - kh + 1, wp - kh + 1
            isz = x.element_size()
            r = check_case(f"conv2d_valid {label}", str(dt).split(".")[1],
                           lambda: cuda_conv.conv2d_valid(x, k),
                           lambda: cuda_conv.conv2d_valid_plain(x, k),
                           lambda: F.conv2d(xn, kn),
                           (x.numel() + k.numel() + n * ho * wo * cout) * isz,
                           2.0 * n * ho * wo * kh * kh * cin * cout, tol, 10)
            res[(label, dt)] = r
    return res[("stage0_embed_8x8", torch.bfloat16)]


def ff_cases(torch, g):
    from credit_torch.ops import cuda_ff

    res = {}
    for label, (h, w, c) in [("stage0_C128", (400, 720, 128)), ("stage2_C512", (100, 180, 512)),
                             ("stage3_C1024", (50, 90, 1024))]:
        for dt, tol in [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)]:
            hd = 4 * c
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
            r = check_case(f"fused_ff {label}", str(dt).split(".")[1],
                           lambda: cuda_ff.fused_ff(x, *prm),
                           lambda: cuda_ff.fused_ff_plain(x, *prm),
                           None,
                           (2 * m * c + 2 * c * hd + 3 * c + hd) * isz,
                           4.0 * m * c * hd, tol, 10)
            res[(label, dt)] = r
    return res[("stage0_C128", torch.bfloat16)]


def attention_cases(torch, g):
    import torch.nn.functional as F

    from credit_torch.ops import cuda_attention

    res = {}
    # stage-0 local windows (T=100), stage-1 long windows (T=25), stage-3
    # long windows (T=1); q, k, v are views of one fused qkv projection
    for label, (nwin, t, heads) in [("stage0_T100", (2880, 100, 4)),
                                    ("stage1_T25", (2880, 25, 8)),
                                    ("stage3_T1", (4500, 1, 32))]:
        for dt, tol in [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)]:
            dh = 32
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
                           4.0 * nwin * heads * t * t * dh, tol, 10)
            res[(label, dt)] = r
    return res[("stage0_T100", torch.bfloat16)]


def tiny_agreement(torch):
    """The tiny model on the card (kernels) against itself on the CPU (plain
    versions, which the CPU tests hold against the JAX package)."""
    from credit_torch.convert_jax import init_folded
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.rollout import make_scan_rollout

    conf = {"model": TINY, "data": TINY_DATA}
    schema = ChannelSchema.from_config(conf)
    cpu = init_folded(conf, torch.Generator().manual_seed(1), device="cpu")
    gpu = init_folded(conf, torch.Generator().manual_seed(1), device="cuda")
    x0 = torch.randn((1, 1, 32, 64, schema.n_input), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = cpu(x0)
        out = gpu(x0.cuda()).cpu()
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    log(f"  tiny forward f32 card vs CPU: rel err {err:.3e} limit 1e-4")
    if not err <= 1e-4:
        raise AssertionError("tiny forward on the card disagrees with the CPU")
    xr, sr = make_scan_rollout(cpu, schema, 2, device="cpu")(x0)
    xg, sg = make_scan_rollout(gpu, schema, 2, device="cuda")(x0)
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


def expected_per_step(conf: dict):
    """Kernel launches of one forward under the port's routing: one FF and
    one attention per half-block; one VALID conv per cross-embed (after
    space-to-depth the stage-0 quadrant conv is 8x8, the padded 2/4 embeds
    2x2), two 3x3 residual convs per UpBlock (its k2 transpose is a 1x1 GEMM)
    and the head's 3x3 phase conv."""
    blocks = sum(conf["depth"])
    return {"fused_ff": 2 * blocks, "fused_window_attention": 2 * blocks,
            "conv2d_valid": 4 + 3 * 2 + 1}


def main_path(torch, profile: bool = False):
    from credit_torch.convert_jax import init_folded
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.ops import cuda_attention, cuda_conv, cuda_ff
    from credit_torch.rollout import make_scan_rollout

    conf = {"model": CONF_025, "data": DATA_025}
    schema = ChannelSchema.from_config(conf)
    t0 = time.time()
    model = init_folded(conf, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    model = model.to(torch.bfloat16)  # weights cast once, as the JAX bench does
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in model.parameters())
    log(f"  CONF_025 model: {nparam} parameters, init+converge+fold {time.time() - t0:.1f} s")
    if schema.n_input != model.base_input_channels or schema.n_prognostic != 56:
        raise AssertionError((schema.n_input, schema.n_prognostic, model.base_input_channels))
    g = torch.Generator(device="cuda").manual_seed(0)
    x0 = (torch.randn((1, 1, 721, 1440, schema.n_input), generator=g, device="cuda")
          * 0.5).to(torch.bfloat16)

    warm = make_scan_rollout(model, schema, 1, device="cuda")
    t0 = time.time()
    xw, _ = warm(x0)
    torch.cuda.synchronize()
    log(f"  warm-up step: {(time.time() - t0) * 1e3:.1f} ms")

    wrappers = {"conv2d_valid": cuda_conv.conv2d_valid, "fused_ff": cuda_ff.fused_ff,
                "fused_window_attention": cuda_attention.fused_window_attention}
    run = make_scan_rollout(model, schema, ROLLOUT_STEPS, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    final_x, stats = run(x0)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"  rollout {ROLLOUT_STEPS} steps: {elapsed * 1e3 / ROLLOUT_STEPS:.1f} ms/step, "
        f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB), launches {counts}")
    want = expected_per_step(CONF_025)
    for k, n in want.items():
        if counts[k] != n * ROLLOUT_STEPS:
            raise AssertionError(f"{k}: {counts[k]} launches, expected {n} x {ROLLOUT_STEPS}")
    if final_x.shape != x0.shape or stats.shape != (ROLLOUT_STEPS, model.base_output_channels):
        raise AssertionError((tuple(final_x.shape), tuple(stats.shape)))
    fin = torch.isfinite(final_x).all().item() and torch.isfinite(stats).all().item()
    amax = final_x.float().abs().max().item()
    log(f"  final state finite: {fin}, max |x| {amax:.3e}; per-step channel means "
        f"range [{stats.float().min().item():.3e}, {stats.float().max().item():.3e}]")
    if not fin:
        raise AssertionError("rollout produced non-finite values")
    if profile:
        profile_steps(torch, model, schema, x0)
    return counts


def profile_steps(torch, model, schema, x0, steps: int = 2) -> None:
    """torch.profiler over a short rollout: device time by kernel and the
    card's idle share of the wall time (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    from credit_torch.rollout import make_scan_rollout

    run = make_scan_rollout(model, schema, steps, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(x0)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # kernels only: an aten op's device time is its kernels' again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    log(f"  profile of a {steps}-step rollout: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:25]:
        log(f"    {ms / steps:9.3f} ms/step {count // steps:5d} calls/step  {name[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true", help="print nvcc's -Xptxas -v report")
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile a 2-step rollout by kernel")
    args = ap.parse_args()

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

    log("phase 3: tiny model on the card against the CPU")
    tiny_agreement(torch)
    log("phase 4: main path, CONF_025 bf16 rollout")
    counts = main_path(torch, args.profile)

    kernels = []
    for name, src, replaces, r in [
            ("conv2d_valid", "credit_torch/csrc/conv_valid.cu",
             "credit_tpu/ops/pallas_conv.py:110", conv),
            ("fused_ff", "credit_torch/csrc/fused_ff.cu", "credit_tpu/ops/pallas_ff.py:475", ff),
            ("fused_window_attention", "credit_torch/csrc/window_attention.cu",
             "credit_tpu/ops/pallas_attention.py:75", attn)]:
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name], **r})
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

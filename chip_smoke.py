#!/usr/bin/env python3
"""Smoke test of the PyTorch port (credit_torch) on one CUDA card.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --ptxas      # also print nvcc's register/smem report
    python3 chip_smoke.py --profile    # also by-kernel profiles of both main paths
                                       # (every row in build/profile_*.txt)

Phases (any failure exits non-zero):
  1. build the kernels from credit_torch/csrc with nvcc (printed seconds);
  2. hold each kernel against its plain PyTorch version on the card, at
     flagship shapes in bf16 and f32 (TF32 off), with the error beside its
     limit and the kernel's, the plain version's and a library call's times;
  3. a tiny CrossFormer, a 2-step rollout and a training step on the card
     against the same model on the CPU (plain versions), and its train-mode
     backward with bf16 compute on the card against f32 on the CPU;
  4. main path 1, the forecast: the 0.25-degree WXFormer (CONF_025 below)
     with seeded folded weights in bf16 at batch 1, a warm-up step, then a
     rollout whose kernel launches are counted and checked against the
     config;
  5. main path 2, training: CONF_025 with 8 diagnostic outputs, seeded f32
     weights with spectral-norm state, bf16 compute, MSE, AdamW(0.9, 0.95)
     through make_train_step; a warm-up step, then timed steps whose kernel
     launches are counted and checked, with ms/step and peak memory.
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
TRAIN_STEPS = 3
# the JAX training bench's configuration (bench.py:557-630): CONF_025 with
# output_only_channels raised so that the outputs cover the 8 diagnostic
# targets (64 outputs, a 256 -> 256 head phase conv), forecast_len 1, batch 1
CONF_025_TRAIN = {**CONF_025, "output_only_channels": 8}
TRAINER = {"learning_rate": 1e-4}


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
    three. tol is relative to max |plain|, for each output of a kernel that
    returns several (the printed error and limit are the worst output's)."""
    import torch

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


def ff_bwd_cases(torch, g):
    from credit_torch.ops import cuda_ff

    res = {}
    for label, (h, w, c) in [("stage0_C128", (400, 720, 128)), ("stage1_C256", (200, 360, 256)),
                             ("stage2_C512", (100, 180, 512)), ("stage3_C1024", (50, 90, 1024))]:
        # bf16: dx is rounded once at the end, and y, a, ct and dh1 enter the
        # products rounded in both versions, so a flipped rounding moves dx by
        # about an ulp; f32: summation order over up to 288000 rows
        for dt, tol in [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)]:
            hd = 4 * c
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
            r = check_case(f"fused_ff_bwd {label}", str(dt).split(".")[1],
                           lambda: cuda_ff.fused_ff_bwd(x, ct, *prm),
                           lambda: cuda_ff.fused_ff_bwd_plain(x, ct, *prm),
                           None,
                           3 * m * c * isz + (2 * c * hd + 3 * c + hd) * (isz + 4),
                           10.0 * m * c * hd, tol, 10)
            res[(label, dt)] = r
    return res[("stage0_C128", torch.bfloat16)]


def wgrad_cases(torch, g):
    from credit_torch.ops import cuda_conv

    res = {}
    # every tap group the training step launches: the stage-0 embed's 8x8
    # after space-to-depth (rows of 4 taps), the stage 1-3 embeds' 2x2 after
    # space-to-depth (2x2 groups), the training head's 3x3 phase conv (rows
    # of 3); both versions sum exact products of the same values in f32 over
    # up to ~300000 pixels, in other orders
    for label, (n, hp, wp, cin, kh, cout) in [("stage0_embed_8x8", (1, 415, 735, 240, 8, 176)),
                                              ("stage1_embed_2x2", (1, 201, 361, 512, 2, 256)),
                                              ("stage2_embed_2x2", (1, 101, 181, 1024, 2, 512)),
                                              ("stage3_embed_2x2", (1, 51, 91, 2048, 2, 1024)),
                                              ("head_phase_3x3", (1, 402, 722, 256, 3, 256))]:
        for dt, tol in [(torch.bfloat16, 5e-4), (torch.float32, 5e-4)]:
            ho, wo = hp - kh + 1, wp - kh + 1
            x = (torch.randn((n, hp, wp, cin), generator=g, device="cuda") * 0.5).to(dt)
            gy = (torch.randn((n, ho, wo, cout), generator=g, device="cuda") * 0.1).to(dt)
            xn, gyn = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)  # NCHW views
            isz = x.element_size()
            r = check_case(f"conv2d_wgrad {label}", str(dt).split(".")[1],
                           lambda: cuda_conv.conv2d_wgrad(x, gy, kh, kh),
                           lambda: cuda_conv.conv2d_wgrad_plain(x, gy, kh, kh),
                           lambda: torch.nn.grad.conv2d_weight(xn, (cout, cin, kh, kh), gyn),
                           (x.numel() + gy.numel()) * isz + kh * kh * cin * cout * 4,
                           2.0 * n * ho * wo * kh * kh * cin * cout, tol, 5)
            res[(label, dt)] = r
    return res[("stage0_embed_8x8", torch.bfloat16)]


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
    tiny_training(torch, conf, schema)


def tiny_training(torch, conf, schema):
    """Train-mode forward and backward of the tiny model with spectral-norm
    state, and one 2-step make_train_step, on the card (kernels 1-5) against
    the CPU (plain versions), f32: loss and gradients within 1e-4."""
    from credit_torch.convert_jax import init_train
    from credit_torch.losses import WeightedLoss
    from credit_torch.trainers.scheduler import constant
    from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step

    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 1, 32, 64, schema.n_input), generator=g)
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
    tiny_training_bf16(torch, conf, x, y, loss_fn, losses["cpu"], grads["cpu"])
    batch = {"x": x, "y": y, "forcing": forcing}
    metrics = {}
    for dev, model in models.items():
        opt = make_optimizer({"trainer": {"grad_max_norm": 1.0, "weight_decay": 0.01}},
                             constant(1e-3))
        step = make_train_step(model, loss_fn, opt, schema, forecast_len=2, device=dev)
        _, metrics[dev] = step(TrainState.create(model, opt, ema=True), batch)
    err = max(abs(float(metrics["cuda"][k]) - float(metrics["cpu"][k])) / abs(float(metrics["cpu"][k]))
              for k in ("loss", "grad_norm"))
    log(f"  tiny 2-step train step f32 card vs CPU: loss and grad norm rel err {err:.3e} "
        f"limit 1e-4")
    if not err <= 1e-4:
        raise AssertionError("tiny train step on the card disagrees with the CPU")


def tiny_training_bf16(torch, conf, x, y, loss_fn, loss_ref, grads_ref):
    """The same train-mode forward and backward with bf16 compute (f32
    parameters, as in CONF_025_TRAIN) on the card, against the f32 CPU run:
    kernels 1-5 in bf16 inside autograd, composed. The limits sit a few
    times above the card's readings (bf16 rounding, not summation order)."""
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
    lims = (1e-3, 5e-2, 0.25)
    log(f"  tiny train-mode bf16 card vs f32 CPU: loss rel err {err:.3e} limit {lims[0]:g}; "
        f"gradients, all parameters: rel err {num / den:.3e} limit {lims[1]:g}; worst "
        f"parameter: rel err {worst:.3e} limit {lims[2]:g}")
    if not (err <= lims[0] and num / den <= lims[1] and worst <= lims[2]):
        raise AssertionError("tiny bf16 training forward/backward on the card is off")


def expected_per_step(conf: dict):
    """Kernel launches of one forward under the port's routing: one FF and
    one attention per half-block; one VALID conv per cross-embed (after
    space-to-depth the stage-0 quadrant conv is 8x8, the padded 2/4 embeds
    2x2), two 3x3 residual convs per UpBlock (its k2 transpose is a 1x1 GEMM)
    and the head's 3x3 phase conv."""
    blocks = sum(conf["depth"])
    return {"fused_ff": 2 * blocks, "fused_window_attention": 2 * blocks,
            "conv2d_valid": 4 + 3 * 2 + 1}


def expected_train_per_step(conf: dict):
    """Kernel launches of one training step at forecast_len 1: the forward's,
    plus per FF one backward kernel, per conv with kh*kw > 1 one weight
    gradient and one input gradient (kernel 1 again) except for the stage-0
    embed, whose input needs none. Attention's backward is autograd of its
    plain version (no kernel)."""
    fwd = expected_per_step(conf)
    return {**fwd, "fused_ff_bwd": fwd["fused_ff"], "conv2d_wgrad": fwd["conv2d_valid"],
            "conv2d_valid": 2 * fwd["conv2d_valid"] - 1}


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
    base = torch.cuda.memory_allocated()
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
        f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB; {base} allocated before it), "
        f"launches {counts}")
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
        from credit_torch.rollout import make_scan_rollout as rollout

        profile_steps(torch, "rollout step", rollout(model, schema, 2, device="cuda"),
                      (x0,), steps=2)


def train_path(torch, wrappers, profile: bool = False):
    from credit_torch.convert_jax import init_train
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.losses import WeightedLoss
    from credit_torch.trainers.scheduler import constant
    from credit_torch.trainers.trainer import TrainState, make_optimizer, make_train_step

    conf = {"model": CONF_025_TRAIN, "data": DATA_025, "trainer": TRAINER}
    schema = ChannelSchema.from_config(conf)
    t0 = time.time()
    model = init_train(conf, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    if schema.n_target != model.base_output_channels or schema.n_target != 64:
        raise AssertionError((schema.n_target, model.base_output_channels))
    nparam = sum(p.numel() for p in model.parameters())
    log(f"  CONF_025 training model: {nparam} f32 parameters with spectral-norm state, "
        f"init+converge {time.time() - t0:.1f} s")
    optimizer = make_optimizer(conf, constant(TRAINER["learning_rate"]))
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, WeightedLoss(base="mse"), optimizer, schema, forecast_len=1,
                           device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"x": torch.randn((1, 1, 721, 1440, schema.n_input), generator=g, device="cuda") * 0.5,
             "y": torch.randn((1, 1, 721, 1440, schema.n_target), generator=g, device="cuda") * 0.5}
    t0 = time.time()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    log(f"  warm-up step: {(time.time() - t0) * 1e3:.1f} ms, loss {float(m['loss']):.6f}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    losses, norms = [], []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    losses, norms = [float(v) for v in losses], [float(v) for v in norms]
    log(f"  CONF_025 training step: {elapsed * 1e3 / TRAIN_STEPS:.1f} ms/step over "
        f"{TRAIN_STEPS} steps, peak memory {peak} bytes ({peak / 2**30:.2f} GiB; {base} "
        f"allocated before it), launches {counts}")
    log(f"  losses {losses}, grad norms {norms}")
    want = expected_train_per_step(CONF_025_TRAIN)
    for k, n in want.items():
        if counts[k] != n * TRAIN_STEPS:
            raise AssertionError(f"{k}: {counts[k]} launches, expected {n} x {TRAIN_STEPS}")
    if not all(math.isfinite(v) for v in losses + norms) or state.step != TRAIN_STEPS + 1:
        raise AssertionError("training produced a non-finite loss or gradient norm")
    if profile:
        profile_steps(torch, "training step", lambda b: step(state, b), (batch,), steps=1)
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
    port = {"ffb::": "port fused_ff_bwd", "ff::": "port fused_ff", "wgrad::": "port conv2d_wgrad",
            "conv::": "port conv2d_valid", "attn::": "port fused_window_attention"}
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
                    help="after each main path, profile a 2-step rollout / a training step "
                         "by kernel")
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
        ff_bwd = ff_bwd_cases(torch, g)
        wgrad = wgrad_cases(torch, g)
    torch.cuda.empty_cache()

    log("phase 3: tiny model on the card against the CPU")
    before = torch.cuda.memory_allocated()
    tiny_agreement(torch)
    log(f"  allocated on the card: {before} bytes before phase 3, "
        f"{torch.cuda.memory_allocated()} after it")
    log("phase 4: main path 1, CONF_025 bf16 rollout")
    main_path(torch, args.profile)
    torch.cuda.empty_cache()
    log("phase 5: main path 2, CONF_025 training step")
    from credit_torch.ops import cuda_attention, cuda_conv, cuda_ff

    wrappers = {"conv2d_valid": cuda_conv.conv2d_valid, "fused_ff": cuda_ff.fused_ff,
                "fused_window_attention": cuda_attention.fused_window_attention,
                "fused_ff_bwd": cuda_ff.fused_ff_bwd, "conv2d_wgrad": cuda_conv.conv2d_wgrad}
    counts = train_path(torch, wrappers, args.profile)

    kernels = []
    for name, src, replaces, r in [
            ("conv2d_valid", "credit_torch/csrc/conv_valid.cu",
             "credit_tpu/ops/pallas_conv.py:110", conv),
            ("fused_ff", "credit_torch/csrc/fused_ff.cu", "credit_tpu/ops/pallas_ff.py:475", ff),
            ("fused_window_attention", "credit_torch/csrc/window_attention.cu",
             "credit_tpu/ops/pallas_attention.py:75", attn),
            ("fused_ff_bwd", "credit_torch/csrc/fused_ff_bwd.cu",
             "credit_tpu/ops/pallas_ff.py:346", ff_bwd),
            ("conv2d_wgrad", "credit_torch/csrc/conv_wgrad.cu",
             "credit_tpu/ops/pallas_conv.py:245", wgrad)]:
        # launches: the training run's (main path 2 runs all five; main
        # path 1's counts are checked in phase 4)
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

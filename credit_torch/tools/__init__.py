"""The port's kernel benches (port of the JAX package's `tools/` probes that
reach a Pallas kernel): `bench_conv` (tools/bench_pallas_conv.py) and
`bench_conv_ffk` (tools/bench_conv_ffk.py). Run on the card as
`python -m credit_torch.tools.<name>`."""

from __future__ import annotations


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Milliseconds per call of fn() on the current CUDA stream, by CUDA
    events around `iters` calls after `warmup` calls."""
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

"""Micro-bench of the stage-0 cross-embed conv followed by four fused
pre-norm feed-forwards, the port of tools/bench_conv_ffk.py.

    python -m credit_torch.tools.bench_conv_ffk [MODE ...]

The input is (1, 800, 1440, 60) bf16; the conv is a 32x32 stride-2 kernel
with padding 15 to 128 channels through `credit_torch.ops.conv.conv2d`
(space-to-depth, then a 16x16 VALID conv over 240 channels on kernel 2),
giving (1, 400, 720, 128); then four FFs at C = 128. Each mode prints ms
per (conv + 4 FF), by CUDA events. Modes (default: xla pallas pallas-t):

- `xla`: the FFs as the tool's plain composition (LN without affine, fc1,
  exact GELU, fc2, residual; bf16 products) in PyTorch;
- `pallas`: the FFs through the fused-FF CUDA kernel (`cuda_ff.fused_ff`);
- `pallas-t`: the same kernel on the transposed (W, H) layout, transposed
  back after each FF;
- `identity`, `identity-input`, `identity-end`: the `xla` FFs plus one
  identity copy through `cuda_probes.copy` (the port of the tool's
  `pallas_identity`) of the conv's output, of the input, or of the result;
- `<mode>-firewall`: the conv's output transposed and back, each a
  `.contiguous()` copy (the tool's transpose / optimization_barrier pair).

`pallas-tiny` is refused with an error: it set a TPU VMEM budget
(`pallas_ff._VMEM_BUDGET`) that has no counterpart on the card. Runs on the
card only.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from credit_torch import resolve_device
from credit_torch.ops import cuda_ff, cuda_probes
from credit_torch.ops.conv import conv2d
from credit_torch.tools import cuda_ms

H, W, CIN, C = 800, 1440, 60, 128
FF_MODES = ("xla", "pallas", "pallas-t", "identity", "identity-input", "identity-end")
MODES = FF_MODES + tuple(f"{m}-firewall" for m in FF_MODES)


def parse(name: str):
    """(firewall, ff) of a mode name; raises for what has no counterpart."""
    if name == "pallas-tiny":
        raise ValueError("pallas-tiny sets a TPU VMEM budget (pallas_ff._VMEM_BUDGET) that has "
                         "no counterpart on the card; use pallas")
    if name not in MODES:
        raise ValueError(f"unknown mode {name!r}; modes: {' '.join(MODES)}")
    return name.endswith("-firewall"), name.split("-firewall")[0]


def launches_per_call(name: str) -> Dict[str, int]:
    """Kernel launches of one (conv + 4 FF) in this mode: one VALID conv
    (16x16, so counted as `conv2d_valid_grouped`), four fused FFs in the
    kernel modes, one copy in the identity modes."""
    _, ff = parse(name)
    return {"conv2d_valid_grouped": 1, "fused_ff": 4 if ff in ("pallas", "pallas-t") else 0,
            "copy": 1 if ff.startswith("identity") else 0}


def _xla_ff(y, w1, w2):
    z = y.float()
    mu = z.mean(-1, keepdim=True)
    var = ((z - mu) ** 2).mean(-1, keepdim=True)
    z = ((z - mu) * torch.rsqrt(var + 1e-5)).to(y.dtype)
    hdn = F.gelu(z.reshape(-1, y.shape[-1]) @ w1)
    o = hdn @ w2
    return y + o.reshape(y.shape)


def make(name: str, seed: int = 0):
    """f(x) -> y for one mode, with the tool's weights (normal x 0.02 in
    bf16, LN scale 1 and shift 0, zero biases) drawn from `seed`, and the
    input x."""
    firewall, ff = parse(name)
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    kern = (torch.randn((32, 32, CIN, C), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    gam = torch.ones(C, device=dev)
    bet = torch.zeros(C, device=dev)
    w1 = (torch.randn((C, 4 * C), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    b1 = torch.zeros(4 * C, device=dev)
    w2 = (torch.randn((4 * C, C), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    b2 = torch.zeros(C, device=dev)
    x = (torch.randn((1, H, W, CIN), generator=g, device=dev) * 0.3).to(torch.bfloat16)

    @torch.no_grad()
    def f(x):
        if ff == "identity-input":
            x = cuda_probes.copy(x)
        y = conv2d(x, kern, None, 2, 15)  # (1, 400, 720, 128)
        if firewall:
            y = y.transpose(1, 2).contiguous()
            y = y.transpose(1, 2).contiguous()
        if ff == "identity":
            y = cuda_probes.copy(y)
        for _ in range(4):
            if ff == "pallas-t":
                yt = cuda_ff.fused_ff(y.transpose(1, 2), gam, bet, w1, b1, w2, b2)
                y = yt.transpose(1, 2)
            elif ff == "pallas":
                y = cuda_ff.fused_ff(y, gam, bet, w1, b1, w2, b2)
            else:
                y = _xla_ff(y, w1, w2)
        if ff == "identity-end":
            y = cuda_probes.copy(y)
        return y

    return f, x


def run(modes: Sequence[str] = ("xla", "pallas", "pallas-t"), iters: int = 3) -> List[Dict]:
    """ms per (conv + 4 FF) of each mode; rows of name, ms, calls (the
    calls of f, warm-up included) and the output's shape and finiteness."""
    for m in modes:
        parse(m)
    rows = []
    for m in modes:
        f, x = make(m)
        y = f(x)
        fin = bool(torch.isfinite(y).all().item())
        ms = cuda_ms(lambda: f(x), iters)
        rows.append({"name": m, "ms": ms, "calls": iters + 2, "shape": tuple(y.shape),
                     "finite": fin})
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        rows = run(argv or ("xla", "pallas", "pallas-t"))
    except ValueError as e:
        print(f"bench_conv_ffk: {e}", file=sys.stderr)
        return 2
    for r in rows:
        print(f"{r['name']:18s}: {r['ms']:7.2f} ms per (conv + 4 FF)", flush=True)
    return 0


if __name__ == "__main__":
    print(f"device: {torch.cuda.get_device_name(0) if torch.cuda.is_available() else 'none'}",
          flush=True)
    sys.exit(main())

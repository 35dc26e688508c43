"""credit_torch: the PyTorch and CUDA port of credit_tpu for NVIDIA Hopper.

Laid out like `credit_tpu`: each module here has one counterpart there,
which is its reference. Activations keep the reference layouts
((B, T, H, W, C) / (B, H, W, C), HWIO conv kernels, (in, out) dense
kernels). The hot ops are hand-written CUDA kernels (`csrc/`, built at first
use by `_build.py`); each has a plain PyTorch version beside it that runs
for CPU tensors.

Entry points take `device="cuda"` by default and raise when CUDA is absent
unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device for an entry point; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "credit_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev

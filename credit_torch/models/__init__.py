"""Model registry and construction (port of credit_tpu/models/__init__.py)."""

from __future__ import annotations

import torch

from credit_torch import registry, resolve_device

PORTED = ("crossformer", "wxformer")


def load_model(conf: dict, device="cuda", sn_state: bool = False) -> torch.nn.Module:
    """Build the model from a gen2 config dict on `device`, in eval mode.

    `conf['model']['type']` selects the architecture; only the CrossFormer
    (`crossformer` / `wxformer`) is ported. The reference's TPU routing keys
    (`pallas_conv`, `ff_fusion`, `use_pallas_attention`, `scan_blocks`,
    `remat`) are accepted and ignored: on CUDA the port always takes its
    kernels. `sn_state=True` keeps spectral norm as u/v buffers beside the
    kernels (training) instead of folded into them. Weights come from
    `convert_jax.init_folded`, `init_train` or `from_jax_variables`; the
    modules start with zero kernels.
    """
    from credit_torch.models import crossformer as _cf  # noqa: F401  (registration)

    mtype = conf["model"]["type"]
    if mtype not in PORTED:
        raise NotImplementedError(
            f"model type {mtype!r} is not ported yet (ROADMAP queue 1, items 8-9); "
            f"ported: {list(PORTED)}")
    dev = resolve_device(device)
    cls = registry.get("model", mtype)
    with torch.device(dev):
        model = cls.from_config(conf, sn_state=sn_state)
    return model.to(dev).eval()  # buffers made from numpy start on the CPU

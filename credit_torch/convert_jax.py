"""Parameters for the port: the bridge from a credit_tpu (flax) variables
tree, and a seeded initialisation with spectral norm converged and folded.

The port's state_dict keys are the flax parameter paths joined with dots
(`transformer0.short_attn0.to_qkv.kernel`), in the same layouts (HWIO conv
kernels, (in, out) dense kernels), so the bridge is a rename after the
spectral fold.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from credit_torch import resolve_device
from credit_torch.models import load_model
from credit_torch.models.spectral_utils import fold_spectral


def _has_key(tree, key: str) -> bool:
    return isinstance(tree, dict) and any(k == key or _has_key(v, key) for k, v in tree.items())


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def expected_state(conf: dict) -> Dict[str, torch.Size]:
    """Parameter names and shapes of the port's model for this config."""
    return {k: v.shape for k, v in load_model(conf, device="meta").state_dict().items()}


def from_jax_variables(variables: Dict[str, Any], conf: dict, device="cuda"
                       ) -> Dict[str, torch.Tensor]:
    """A state_dict for `load_model(conf)` from flax variables given as
    nested dicts of numpy arrays ({"params": ..., "spectral": ...}). When
    `spectral` is present every kernel with a u/v pair is divided by
    sigma = u . (W v) in f32, as credit_tpu's fold_spectral does. Unknown,
    missing or misshapen parameters raise."""
    dev = resolve_device(device)
    params = variables["params"]
    if _has_key(params, "blocks"):
        raise NotImplementedError(
            "the stacked blocks/ layout of scan_blocks is not bridged yet (ROADMAP queue 1, "
            "item 1): convert it with credit_tpu's unstacking first")
    tree = {"params": _to_torch(params)}
    if variables.get("spectral"):
        tree["spectral"] = _to_torch(variables["spectral"])
    state = _flatten(fold_spectral(tree)["params"])
    want = expected_state(conf)
    missing = sorted(set(want) - set(state))
    unknown = sorted(set(state) - set(want))
    if missing or unknown:
        raise KeyError(f"parameters do not match the port's model: missing {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''}, unknown {unknown[:8]}"
                       f"{'...' if len(unknown) > 8 else ''}")
    for k, shape in want.items():
        if state[k].shape != shape:
            raise ValueError(f"{k}: shape {tuple(state[k].shape)} != {tuple(shape)}")
    return {k: v.to(dev) for k, v in state.items()}


def init_folded(conf: dict, generator: torch.Generator, device="cuda",
                n_iter: int = 30) -> torch.nn.Module:
    """The model for `conf` with seeded weights: kernels he_uniform
    (U(-sqrt(6/fan_in), +sqrt(6/fan_in)), fan_in = every axis but the last),
    biases zero, norm scales one. With `use_spectral_norm` (the default) each
    kernel is then divided by its spectral norm, estimated from random unit
    u, v after n_iter power iterations in f64, as credit_tpu's
    converge_spectral + fold_spectral do, so activations stay bounded at
    full scale. Draws come from `generator` on its own device."""
    dev = resolve_device(device)
    model = load_model(conf, device=dev)
    use_sn = conf["model"].get("use_spectral_norm", True)
    gdev = generator.device
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith("kernel"):
                continue
            fan_in = math.prod(p.shape[:-1])
            limit = math.sqrt(6.0 / fan_in)
            k = (torch.rand(p.shape, generator=generator, device=gdev) * 2 - 1) * limit
            k = k.to(dev)
            if use_sn:
                w = k.double().reshape(-1, p.shape[-1]).T  # (O, rest)
                u = torch.randn(w.shape[0], generator=generator, device=gdev).to(dev).double()
                v = torch.randn(w.shape[1], generator=generator, device=gdev).to(dev).double()
                u, v = u / (u.norm() + 1e-12), v / (v.norm() + 1e-12)
                for _ in range(n_iter):
                    v = w.T @ u
                    v = v / (v.norm() + 1e-12)
                    u = w @ v
                    u = u / (u.norm() + 1e-12)
                sigma = torch.dot(u.float(), w.float() @ v.float())
                k = k / sigma
            p.copy_(k)
    return model

"""Parameters for the port: the bridge from a credit_tpu (flax) variables
tree, and seeded initialisations with spectral norm converged, folded
(`init_folded`, inference) or kept as u/v state (`init_train`, training).

The port's state_dict keys are the flax parameter paths joined with dots
(`transformer0.short_attn0.to_qkv.kernel`), in the same layouts (HWIO conv
kernels, (in, out) dense kernels), so the bridge is a rename: after the
spectral fold, or with each u/v leaf of the `spectral` collection kept as
the buffer of the same path (`transformer0.short_attn0.to_qkv.u`). The
trainable postblocks' nets (credit_tpu's `params['_postblocks']`, flax
Dense and Conv kernels in the same layouts) carry across the same way, as
`_postblocks.<i>.<path>` (`postblocks_from_jax`).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from credit_torch import resolve_device
from credit_torch.models import load_model
from credit_torch.models.scan_utils import unstack_block_params
from credit_torch.models.spectral_utils import fold_spectral, power_iteration
from credit_torch.ops.upsample import icnr_kernel, truncated_normal


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


def expected_state(conf: dict, sn_state: bool = False) -> Dict[str, torch.Size]:
    """Parameter (and u/v buffer) names and shapes of the port's model for
    this config."""
    model = load_model(conf, device="meta", sn_state=sn_state)
    return {k: v.shape for k, v in model.state_dict().items()}


def from_jax_variables(variables: Dict[str, Any], conf: dict, device="cuda", fold: bool = True
                       ) -> Dict[str, torch.Tensor]:
    """A state_dict for `load_model(conf)` from flax variables given as
    nested dicts of numpy arrays ({"params": ..., "spectral": ...}), in the
    unrolled or the stacked (`scan_blocks`, `blocks/`) layout. When
    `spectral` is present and `fold`, every kernel with a u/v pair is divided
    by sigma = u . (W v) in f32, as credit_tpu's fold_spectral does; with
    `fold=False` the kernels stay as they are and each u/v becomes a buffer
    for `load_model(conf, sn_state=True)`. Unknown, missing or misshapen
    entries raise; `params['_postblocks']` is left to `postblocks_from_jax`."""
    dev = resolve_device(device)
    params = {k: v for k, v in variables["params"].items() if k != "_postblocks"}
    tree = {"params": _to_torch(unstack_block_params(params))}
    if variables.get("spectral"):
        tree["spectral"] = _to_torch(unstack_block_params(variables["spectral"]))
    sn_state = not fold and "spectral" in tree
    if sn_state:
        state = {**_flatten(tree["params"]), **_flatten(tree["spectral"])}
    else:
        state = _flatten(fold_spectral(tree)["params"])
    want = expected_state(conf, sn_state)
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


def postblocks_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, torch.Tensor]:
    """credit_tpu's trainable-postblock parameters ({str(i): flax params of
    block i's net}, `params['_postblocks']`, numpy leaves) as the port's
    `_postblocks.<i>.<path>` tensors: the layouts are the same (Dense
    kernels (in, out), Conv kernels HWIO), so it is a rename."""
    dev = resolve_device(device)
    return {f"_postblocks.{k}": v.to(dev) for k, v in _flatten(_to_torch(dict(tree))).items()}


def _init_spec(module: torch.nn.Module, name: str):
    """The seeded initialisation of parameter `name` of `module`: its
    `seed_init` entry, or for a `kernel` its layer's `kernel_init`
    (he_uniform by default); None keeps the value the module starts with."""
    spec = getattr(module, "seed_init", {}).get(name)
    if spec is None and name == "kernel":
        spec = getattr(module, "kernel_init", ("he_uniform",))
    return spec


def _draw(spec, shape, generator: torch.Generator) -> torch.Tensor:
    """Seeded values of one parameter on the generator's device:
    ("he_uniform"[, fan_in]) U(-sqrt(6/fan_in), +sqrt(6/fan_in)), fan_in
    every axis but the last unless given; ("normal", std); ("xavier_normal",)
    a truncated normal of variance 2 / (fan_in + fan_out); ("icnr", scale)
    (ops.upsample.icnr_kernel); ("zeros",)."""
    kind, gdev = spec[0], generator.device
    if kind == "he_uniform":
        fan_in = spec[1] if len(spec) > 1 else math.prod(shape[:-1])
        limit = math.sqrt(6.0 / fan_in)
        return (torch.rand(shape, generator=generator, device=gdev) * 2 - 1) * limit
    if kind == "normal":
        return torch.randn(shape, generator=generator, device=gdev) * spec[1]
    if kind == "xavier_normal":
        fan_in = math.prod(shape[:-1])
        fan_out = math.prod(shape[:-2]) * shape[-1]
        return truncated_normal(shape, math.sqrt(2.0 / (fan_in + fan_out)), generator)
    if kind == "icnr":
        return icnr_kernel(shape, spec[1], generator)
    if kind == "zeros":
        return torch.zeros(shape, device=gdev)
    raise ValueError(f"unknown initialisation {spec!r}")


def _seeded_params(model: torch.nn.Module, conf: dict, generator: torch.Generator, dev,
                    n_iter: int):
    """For each parameter of `model` that credit_tpu initialises randomly
    (`_init_spec`: every kernel, he_uniform unless its layer says
    otherwise, and the parameters a module lists in `seed_init`): (module
    path, parameter, seeded value, u, v). Where a kernel's layer carries
    spectral norm (its `spectral` flag, under the model's
    `use_spectral_norm`) and is not zero-initialised, u and v are random
    unit vectors run n_iter power iterations against it in f64, as
    credit_tpu's converge_spectral does; elsewhere they are None. Draws
    come from `generator` on its own device, in parameter order. Every
    other parameter keeps the value its module starts with (biases 0, norm
    scales 1, SwinV2 logit scales log 10)."""
    use_sn = getattr(model, "use_spectral_norm", conf["model"].get("use_spectral_norm", True))
    mods = dict(model.named_modules())
    gdev = generator.device
    for name, p in model.named_parameters():
        path, _, pname = name.rpartition(".")
        spec = _init_spec(mods[path], pname)
        if spec is None:
            continue
        k = _draw(spec, p.shape, generator).to(dev)
        u = v = None
        if (pname == "kernel" and spec[0] != "zeros" and use_sn
                and getattr(mods[path], "spectral", False)):
            w = k.double().reshape(-1, p.shape[-1]).T  # (O, rest)
            u = torch.randn(w.shape[0], generator=generator, device=gdev).to(dev).double()
            v = torch.randn(w.shape[1], generator=generator, device=gdev).to(dev).double()
            u, v = u / (u.norm() + 1e-12), v / (v.norm() + 1e-12)
            u, v = power_iteration(w, u, v, n_iter)
        yield path, p, k, u, v


def init_folded(conf: dict, generator: torch.Generator, device="cuda",
                n_iter: int = 30) -> torch.nn.Module:
    """The inference model for `conf` with seeded weights (`_seeded_params`).
    With `use_spectral_norm` (the default) each kernel of a spectrally
    normalised layer is divided by sigma = u . (W v) of its converged u, v,
    as credit_tpu's converge_spectral + fold_spectral do, so activations
    stay bounded at full scale."""
    dev = resolve_device(device)
    model = load_model(conf, device=dev)
    with torch.no_grad():
        for _, p, k, u, v in _seeded_params(model, conf, generator, dev, n_iter):
            if u is not None:
                w = k.reshape(-1, p.shape[-1]).T.float()
                k = k / torch.dot(u.float(), w @ v.float())
            p.copy_(k)
    return model


def init_train(conf: dict, generator: torch.Generator, device="cuda",
               n_iter: int = 30) -> torch.nn.Module:
    """The training model for `conf` (`load_model(conf, sn_state=True)`,
    f32 parameters) with the same seeded draws as `init_folded`, but with
    the kernels unfolded and each converged u, v (f32) in its layer's
    buffers, as after credit_tpu's init + converge_spectral. In eval mode;
    call `.train()` to iterate spectral norm per forward."""
    dev = resolve_device(device)
    return seed_train_(load_model(conf, device=dev, sn_state=True), conf, generator, n_iter)


def seed_train_(model: torch.nn.Module, conf: dict, generator: torch.Generator,
                n_iter: int = 30) -> torch.nn.Module:
    """`init_train`'s weights written into `model` in place (a model of
    `load_model(conf, sn_state=True)`, on any device): the seeded kernels,
    and each spectrally normalised layer's converged u, v."""
    dev = next(model.parameters()).device
    mods = dict(model.named_modules())
    with torch.no_grad():
        for path, p, k, u, v in _seeded_params(model, conf, generator, dev, n_iter):
            p.copy_(k)
            if u is not None:
                if mods[path].u is None:
                    raise ValueError(f"{path} has no spectral-norm state: build the model "
                                     "with load_model(conf, sn_state=True)")
                mods[path].u.copy_(u)
                mods[path].v.copy_(v)
    return model

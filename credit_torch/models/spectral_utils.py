"""Spectral-norm state utilities (port of credit_tpu/models/spectral_utils.py
and of the train-mode half of `layers.SNMixin`).

Trees are nested dicts shaped like flax variables: `params` holds each
layer's `kernel`, and `spectral` mirrors it with that layer's `u` (O,) and
`v` (rest,) vectors. With the kernel reshaped to W = kernel.reshape(-1, O).T,
sigma = u . (W v). A power iteration is v = normalize(W^T u);
u = normalize(W v).
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def _l2(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def _w2d(kernel: torch.Tensor, dtype) -> torch.Tensor:
    return kernel.to(dtype).reshape(-1, kernel.shape[-1]).T  # (O, rest)


def _walk(spec: dict, prm: dict, fn) -> dict:
    """Apply fn(spec_leaf, prm_leaf) -> new spec leaf at every layer that has
    u, v and a kernel; returns the new spectral tree."""
    if "u" in spec and "v" in spec and "kernel" in prm:
        return fn(spec, prm)
    return {k: _walk(sub, prm[k], fn) if isinstance(sub, dict) and k in prm else sub
            for k, sub in spec.items()}


def power_iteration(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor, n_iter: int = 1):
    """(u, v) after n_iter power iterations against w (O, rest), in w's dtype."""
    for _ in range(n_iter):
        v = _l2(w.T @ u)
        u = _l2(w @ v)
    return u, v


def sn_kernel(kernel: torch.Tensor, u: torch.Tensor, v: torch.Tensor, update: bool
              ) -> torch.Tensor:
    """kernel / sigma with torch spectral_norm semantics, as credit_tpu's
    SNMixin._sn_kernel: with `update` (train mode) one power iteration
    refreshes the u, v buffers in place under no_grad first; then
    sigma = u . (W v) in f32 keeps its gradient to the kernel."""
    w2d = _w2d(kernel, torch.float32)
    if update:
        with torch.no_grad():
            un, vn = power_iteration(w2d, u, v)
            u.copy_(un)
            v.copy_(vn)
    # copies: a later in-place refresh must not touch what autograd saved
    sigma = torch.dot(u.clone(), w2d @ v.clone())
    return (kernel.float() / sigma).to(kernel.dtype)


def power_iter_spectral(params: Dict[str, Any], spectral: Dict[str, Any], n_iter: int = 1
                        ) -> Dict[str, Any]:
    """A new spectral tree with n_iter power iterations (f32) of every u/v
    pair against the current params. Stacked layers (u of shape (depth, O),
    the scan_blocks layout) iterate each slice of the leading axis."""

    def one(u, v, kernel):
        return power_iteration(_w2d(torch.as_tensor(kernel), torch.float32), u, v, n_iter)

    def layer(spec, prm):
        u = torch.as_tensor(spec["u"]).float()
        v = torch.as_tensor(spec["v"]).float()
        k = torch.as_tensor(prm["kernel"])
        if u.dim() == 2:
            pairs = [one(u[i], v[i], k[i]) for i in range(u.shape[0])]
            u, v = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
        else:
            u, v = one(u, v, k)
        return {**spec, "u": u, "v": v}

    return _walk(spectral, params, layer)


def power_iter_model_(model: torch.nn.Module, n_iter: int = 1) -> None:
    """In place: n_iter power iterations (f32) of every spectral-norm u/v
    buffer pair of `model` against its layer's current kernel, as
    credit_tpu's power_iter_spectral does to the spectral tree (the
    out-of-step half of trainer.sn_external)."""
    with torch.no_grad():
        for m in model.modules():
            if getattr(m, "u", None) is None or getattr(m, "kernel", None) is None:
                continue
            u, v = power_iteration(_w2d(m.kernel, torch.float32), m.u.float(), m.v.float(), n_iter)
            m.u.copy_(u)
            m.v.copy_(v)


def converge_spectral(variables: Dict[str, Any], n_iter: int = 30) -> Dict[str, Any]:
    """A copy of `variables` with every u/v pair run n_iter power iterations
    (v = normalize(W^T u); u = normalize(W v)) against its kernel, in f64."""
    if "spectral" not in variables:
        return variables

    def one(spec, prm):
        w = _w2d(torch.as_tensor(prm["kernel"]), torch.float64)
        u = torch.as_tensor(spec["u"]).to(device=w.device, dtype=torch.float64)
        v = torch.as_tensor(spec["v"]).to(device=w.device, dtype=torch.float64)
        u, v = power_iteration(w, u, v, n_iter)
        return {**spec, "u": u.float(), "v": v.float()}

    return {**variables, "spectral": _walk(variables["spectral"], variables["params"], one)}


def fold_spectral(variables: Dict[str, Any]) -> Dict[str, Any]:
    """Inference fold: kernel <- kernel / sigma(u, v) in f32, then drop the
    spectral collection."""
    if "spectral" not in variables:
        return variables
    sigmas = {}

    def collect(spec, prm):
        w = _w2d(torch.as_tensor(prm["kernel"]), torch.float32)
        u = torch.as_tensor(spec["u"]).to(device=w.device, dtype=torch.float32)
        v = torch.as_tensor(spec["v"]).to(device=w.device, dtype=torch.float32)
        sigmas[id(prm)] = torch.dot(u, w @ v)
        return spec

    _walk(variables["spectral"], variables["params"], collect)

    def fold(prm):
        if not isinstance(prm, dict):
            return prm
        out = {k: fold(sub) for k, sub in prm.items()}
        if id(prm) in sigmas:
            k = torch.as_tensor(prm["kernel"])
            out["kernel"] = (k.float() / sigmas[id(prm)]).to(k.dtype)
        return out

    rest = {k: v for k, v in variables.items() if k != "spectral"}
    rest["params"] = fold(variables["params"])
    return rest

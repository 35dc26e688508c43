"""Spectral-norm state utilities (port of the inference half of
credit_tpu/models/spectral_utils.py).

Trees are nested dicts shaped like flax variables: `params` holds each
layer's `kernel`, and `spectral` mirrors it with that layer's `u` (O,) and
`v` (rest,) vectors. With the kernel reshaped to W = kernel.reshape(-1, O).T,
sigma = u . (W v). The train-mode power iteration is not ported yet
(ROADMAP queue 1, item 3).
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


def converge_spectral(variables: Dict[str, Any], n_iter: int = 30) -> Dict[str, Any]:
    """A copy of `variables` with every u/v pair run n_iter power iterations
    (v = normalize(W^T u); u = normalize(W v)) against its kernel, in f64."""
    if "spectral" not in variables:
        return variables

    def one(spec, prm):
        w = _w2d(torch.as_tensor(prm["kernel"]), torch.float64)
        u = torch.as_tensor(spec["u"]).to(device=w.device, dtype=torch.float64)
        v = torch.as_tensor(spec["v"]).to(device=w.device, dtype=torch.float64)
        for _ in range(n_iter):
            v = _l2(w.T @ u)
            u = _l2(w @ v)
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

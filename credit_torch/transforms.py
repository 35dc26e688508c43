"""Invertible per-variable data transforms for regional/downscaling pipelines
(the port's own copy of credit_tpu/transforms.py, numpy only).

Behavioral equivalent of the reference's downscaling transform stack
(reference: credit/transforms_downscaling.py:26-205 — Expand, Pad, Minmax,
Zscore, Power, Clip, Identity and the per-variable DataTransforms
composition with netCDF-stored parameters). Works on numpy arrays (pure
elementwise/pad/slice ops); every transform takes `inverse=True` to run
the exact inverse, and compositions invert in reverse order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Expand", "Pad", "Minmax", "Zscore", "Power", "Clip", "Identity",
           "rescale", "DataTransforms", "TRANSFORMS"]


@dataclass
class Expand:
    """Repeat x/y elements `by` times — nearest-neighbor upsampling of
    coarse data for single-funnel downscaling; inverse is strided
    subsampling (reference transforms_downscaling.py:26)."""

    by: int

    def __call__(self, x, inverse: bool = False):
        if inverse:
            return x[..., ::self.by, ::self.by]
        return np.repeat(np.repeat(np.asarray(x), self.by, axis=-1),
                         self.by, axis=-2)


@dataclass
class Pad:
    """Edge-pad the trailing (y, x) dims; inverse crops back
    (reference transforms_downscaling.py:38)."""

    left: int = 0
    right: int = 0
    top: int = 0
    bottom: int = 0
    mode: str = "edge"

    def __call__(self, x, inverse: bool = False):
        if inverse:
            ny, nx = x.shape[-2], x.shape[-1]
            return x[..., self.bottom:ny - self.top, self.left:nx - self.right]
        pad = ((self.bottom, self.top), (self.left, self.right))
        pad = ((0, 0),) * (x.ndim - 2) + pad
        return np.pad(np.asarray(x), pad, mode=self.mode)


def rescale(x, offset=0, scale=1, inverse: bool = False):
    if inverse:
        return x * scale + offset
    return (x - offset) / scale


@dataclass
class Minmax:
    mmin: float
    mmax: float

    def __call__(self, x, inverse: bool = False):
        return rescale(x, self.mmin, self.mmax - self.mmin, inverse)


@dataclass
class Zscore:
    mean: float = 0.0
    stdev: float = 1.0

    def __call__(self, x, inverse: bool = False):
        return rescale(x, self.mean, self.stdev, inverse)


@dataclass
class Power:
    exponent: float

    def __call__(self, x, inverse: bool = False):
        if inverse:
            return np.power(x, 1.0 / self.exponent)
        return np.power(x, self.exponent)


@dataclass
class Clip:
    """Clamp to [cmin, cmax]; the inverse clips too — values that were
    clipped on input should stay clipped on output
    (reference transforms_downscaling.py:105)."""

    cmin: Optional[float] = None
    cmax: Optional[float] = None

    def __call__(self, x, inverse: bool = False):
        return np.clip(x, self.cmin, self.cmax)


@dataclass
class Identity:
    def __call__(self, x, inverse: bool = False, **kwargs):
        return x


TRANSFORMS = {
    "expand": Expand,
    "minmax": Minmax,
    "zscore": Zscore,
    "power": Power,
    "clip": Clip,
    "pad": Pad,
    "none": Identity,
}


class DataTransforms:
    """Per-variable transform chains from a config dict.

    transdict maps variable name (or "default") to either the string
    "none" or an ordered {transform_name: kwargs} mapping; kwargs may be
    the string "paramfile" to pull per-variable parameter arrays from the
    netCDF files named in transdict["paramfiles"] (reference
    transforms_downscaling.py:125 DataTransforms).

    vardict: {usage: [var, ...]} (usage "unused" skipped).
    """

    def __init__(self, vardict: Dict[str, List[str]], transdict: dict,
                 rootpath: str = ".", dim: str = "2D", zstride: int = 1):
        if zstride != 1 and dim != "3D":
            raise ValueError("zstride > 1 only allowed for dim=='3D'")
        variables: List[str] = []
        for usage, names in vardict.items():
            if usage != "unused":
                variables.extend(names)

        fileparams: Dict[str, Dict[str, np.ndarray]] = {}
        if "paramfiles" in transdict:
            from credit_torch.utils.ncio import open_dataset

            for par, fname in transdict["paramfiles"].items():
                ds = open_dataset(os.path.join(rootpath, fname))
                for var in variables:
                    if var in ds:
                        v = np.asarray(ds[var].values)
                        if dim == "3D" and zstride != 1:
                            v = v[:, ::zstride, ...]
                        fileparams.setdefault(var, {})[par] = v

        self.transforms: Dict[str, list] = {}
        for var in variables:
            chain = []
            key = var if var in transdict else (
                "default" if "default" in transdict else None)
            if key is None or transdict[key] == "none":
                chain.append(Identity())
            else:
                for name, kwargs in transdict[key].items():
                    cls = TRANSFORMS[name]
                    if kwargs == "paramfile":
                        import inspect

                        pars = list(inspect.signature(cls).parameters)
                        kwargs = {p: fileparams[var][p] for p in pars
                                  if p in fileparams.get(var, {})}
                    chain.append(cls(**(kwargs or {})))
            self.transforms[var] = chain

    def __call__(self, x: Dict[str, Dict[str, np.ndarray]],
                 inverse: bool = False):
        """x: nested {usage: {var: array[time,(z),y,x]}} — transformed in
        place and returned; inverse applies the chains reversed."""
        for usage in x:
            for var in x[usage]:
                chain = self.transforms.get(var, [Identity()])
                if inverse:
                    for t in reversed(chain):
                        x[usage][var] = t(x[usage][var], inverse=True)
                else:
                    for t in chain:
                        x[usage][var] = t(x[usage][var], inverse=False)
        return x

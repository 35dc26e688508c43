"""Losses: port of credit_tpu/losses/__init__.py, elementwise losses and the
latitude- and variable-weighted `WeightedLoss`.

Layout is channels-last (B, T, lat, lon, C). Elementwise losses return
unreduced fields; `WeightedLoss` applies the weights and takes the mean.
The spectral and power terms, the CRPS family and `DownscalingLoss` are not
ported yet (ROADMAP queue 1, item 3) and raise.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from credit_torch import registry


@registry.register("loss", "mse")
def mse(target, pred):
    return (pred - target) ** 2


@registry.register("loss", "mae")
def mae(target, pred):
    return torch.abs(pred - target)


@registry.register("loss", "msle")
def msle(target, pred):
    return (torch.log1p(pred) - torch.log1p(target)) ** 2


@registry.register("loss", "huber")
def huber(target, pred, delta: float = 1.0):
    err = torch.abs(pred - target)
    quad = torch.clamp(err, max=delta)
    return 0.5 * quad ** 2 + delta * (err - quad)


@registry.register("loss", "logcosh")
def logcosh(target, pred):
    e = target - pred + 1e-12
    # numerically stable log(cosh(e))
    return e + F.softplus(-2.0 * e) - math.log(2.0)


@registry.register("loss", "xtanh")
def xtanh(target, pred):
    e = target - pred + 1e-12
    return e * torch.tanh(e)


@registry.register("loss", "xsigmoid")
def xsigmoid(target, pred):
    e = target - pred + 1e-12
    return 2.0 * e * torch.sigmoid(e) - e


def load_loss(name: str, **kw) -> Callable:
    """Look up an elementwise loss by config key."""
    if is_crps_loss(name) or name in ("spectral", "power", "covmse"):
        raise NotImplementedError(f"loss {name!r} is not ported yet (ROADMAP queue 1, item 3)")
    fn = registry.get("loss", name)
    return functools.partial(fn, **kw) if kw else fn


def is_crps_loss(name: str) -> bool:
    return "crps" in name.lower() or name == "KCRPS"


class WeightedLoss:
    """Latitude- and variable-weighted total loss (credit_tpu's WeightedLoss
    without its auxiliary terms).

    Args:
      base: elementwise loss key, e.g. 'mse'.
      lat_weights: (nlat,) cos-lat weights normalized to mean 1, or None.
      var_weights: (C,) per-channel weights, or None.
      spectral_lambda / power_lambda: must be 0 (not ported yet).
    """

    def __init__(self, base: str = "mse", lat_weights=None, var_weights=None,
                 spectral_lambda: float = 0.0, power_lambda: float = 0.0,
                 wavenum_init: int = 20, validation: bool = False, **base_kw):
        if (spectral_lambda or power_lambda) and not validation:
            raise NotImplementedError("the spectral and power loss terms are not ported yet "
                                      "(ROADMAP queue 1, item 3)")
        self.base_name = base
        self.base = load_loss(base, **base_kw)
        self.lat_weights = None if lat_weights is None else torch.as_tensor(
            np.asarray(lat_weights, np.float32))
        self.var_weights = None if var_weights is None else torch.as_tensor(
            np.asarray(var_weights, np.float32))

    @classmethod
    def from_config(cls, conf: dict, grid=None, validation: bool = False) -> "WeightedLoss":
        """From the config's `loss` section. `grid` gives the latitude weights
        through its `coslat_weights()`, as credit_tpu's Grid does."""
        if "datasets" in (conf.get("data") or {}):
            raise NotImplementedError("DownscalingLoss is not ported yet (ROADMAP queue 1, item 3)")
        lconf = conf.get("loss", {})
        key = "validation_loss" if (validation and "validation_loss" in lconf) else "training_loss"
        lat_w = None
        if lconf.get("use_latitude_weights") and grid is not None:
            lat_w = grid.coslat_weights()
        var_w = None
        if lconf.get("use_variable_weights"):
            flat = []
            for v in lconf["variable_weights"].values():
                flat.extend(v if isinstance(v, (list, tuple)) else [v])
            var_w = np.asarray(flat, np.float32)
        lam = lconf.get("spectral_lambda_reg", 0.0)
        return cls(base=lconf.get(key, "mse"), lat_weights=lat_w, var_weights=var_w,
                   spectral_lambda=lam if lconf.get("use_spectral_loss") else 0.0,
                   power_lambda=lam if lconf.get("use_power_loss") else 0.0,
                   wavenum_init=lconf.get("spectral_wavenum_init", 20), validation=validation)

    def __call__(self, target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """target, pred: (B, T, lat, lon, C). Returns a scalar."""
        field = self.base(target, pred)
        if self.lat_weights is not None:
            field = field * self.lat_weights.to(field.device)[:, None, None]
        if self.var_weights is not None:
            field = field * self.var_weights.to(field.device)
        return torch.mean(field)

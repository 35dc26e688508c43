"""Losses: port of credit_tpu/losses/__init__.py: the elementwise losses,
the CRPS family, the spectral-domain losses and the latitude- and
variable-weighted `WeightedLoss` with its spectral and power terms.

Layout is channels-last (B, T, lat, lon, C); ensemble losses take the
prediction with an ensemble axis 1, (B, E, T, lat, lon, C). Elementwise and
CRPS losses return unreduced fields; `WeightedLoss` applies the weights and
takes the mean; `DownscalingLoss` is its form for regional downscaling
configs. `ring-crps` runs the device ring (parallel/ring_crps.py) when
given a process group, the dense fair estimator otherwise.
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


# --------------------------------------------------------------------------
# CRPS family (ensemble): pred has ensemble axis 1, (B, E, ...)


def kcrps(target, pred, biased: bool = False):
    """Kernel CRPS, O(m log m) through a sort over the members (reference:
    credit/losses/kcrps.py, the Zamo & Naveau fair estimator when
    biased=False). Returns the CRPS field with the shape of `target`."""
    m = pred.shape[1]
    skill = torch.abs(pred - target[:, None]).mean(dim=1)
    ps = torch.sort(pred, dim=1).values
    i = torch.arange(1, m + 1, dtype=pred.dtype, device=pred.device)
    denom = m * m if biased else m * (m - 1)
    factor = (2 * i - m - 1) / denom
    spread = torch.tensordot(factor, ps.movedim(1, 0), dims=1)
    return skill - spread


registry.register("loss", "KCRPS")(kcrps)


@registry.register("loss", "almost-fair-crps")
def almost_fair_crps(target, pred, alpha: float = 1.0):
    """Almost-fair kernel CRPS (reference: credit/losses/almost_fair_crps.py):
    skill - (1 - eps) * spread with eps = (1 - alpha) / m; the spread
    excludes i == j. It forms the (B, m, m, ...) member differences."""
    m = pred.shape[1]
    eps = (1.0 - alpha) / m
    skill = torch.abs(pred - target[:, None]).mean(dim=1)
    diffs = torch.abs(pred[:, :, None] - pred[:, None, :])
    spread = diffs.sum(dim=(1, 2)) / (2.0 * m * (m - 1))
    return skill - (1.0 - eps) * spread


def crps_ensemble(target, pred):
    """Unreduced fair kernel CRPS per grid point (alias used by metrics)."""
    return kcrps(target, pred, biased=False)


@registry.register("loss", "ring-crps")
def ring_crps_loss(target, pred, axis_name=None):
    """Ring CRPS (reference: credit/losses/crps.py RingCRPSLoss: one member
    per dp rank, m - 1 shifts). With `axis_name` a process group (the dp
    group of a mesh: `mesh.group("dp")`), `pred` is this rank's member and
    the result the ring's scalar fair CRPS
    (credit_torch.parallel.ring_crps.ring_crps); otherwise the numerically
    identical dense fair estimator on the ensemble axis, as credit_tpu
    falls back outside shard_map."""
    if axis_name is not None:
        from credit_torch.parallel.ring_crps import ring_crps

        return ring_crps(pred, target, axis_name)
    return kcrps(target, pred, biased=False)


# --------------------------------------------------------------------------
# spectral-domain losses (scalars)


@registry.register("loss", "spectral")
def spectral_loss(target, pred, lat_weights=None, wavenum_init: int = 20):
    """FFT-amplitude loss over longitude (reference:
    credit/losses/spectral.py): rfft over lon, |.|, the mean over latitude
    (weighted by lat_weights / nlat when given), the squared error over
    wavenumbers >= wavenum_init, in f32. Layout (..., lat, lon, C)."""
    p = pred.float().movedim(-1, -3)  # (..., C, lat, lon)
    t = target.float().movedim(-1, -3)
    pf = torch.abs(torch.fft.rfft(p, dim=-1))
    tf = torch.abs(torch.fft.rfft(t, dim=-1))
    if lat_weights is not None:
        w = (torch.as_tensor(lat_weights, device=pf.device) / lat_weights.shape[-1]).float()
        pm = torch.einsum("l,...lk->...k", w, pf)
        tm = torch.einsum("l,...lk->...k", w, tf)
    else:
        pm = pf.mean(dim=-2)
        tm = tf.mean(dim=-2)
    return torch.mean((pm[..., wavenum_init:] - tm[..., wavenum_init:]) ** 2)


@registry.register("loss", "power")
def power_loss(target, pred, lat_weights=None, wavenum_init: int = 20):
    """Log-PSD squared-error loss (reference: credit/losses/power.py): the
    one-sided power spectrum over longitude (rfft, norm="forward"), the
    squared difference of its logs past wavenum_init, averaged over
    latitude with weights lat_weights / sum (1 / nlat without)."""

    def psd(x):
        xk = torch.fft.rfft(x.float(), dim=-1, norm="forward")
        mag = (xk * torch.conj(xk)).real
        scale = torch.full((mag.shape[-1],), 2.0, device=mag.device)
        scale[0] = 1.0
        return mag * scale

    p = pred.movedim(-1, -3)
    t = target.movedim(-1, -3)
    diff = (torch.log(psd(t) + 1e-8) - torch.log(psd(p) + 1e-8))[..., wavenum_init:] ** 2
    nlat = diff.shape[-2]
    if lat_weights is None:
        w = torch.full((nlat,), 1.0 / nlat, device=diff.device)
    else:
        lw = torch.as_tensor(lat_weights, device=diff.device)
        w = (lw / lw.sum()).float()
    return torch.mean(torch.einsum("l,...lk->...k", w, diff))


@registry.register("loss", "covmse")
def covariance_weighted_mse(target, pred):
    """The squared error over each channel's variance of the target (all
    axes but the last, population variance) + 1e-8, as credit_tpu's
    covmse."""
    err = (pred - target) ** 2
    var = torch.var(target, dim=tuple(range(target.ndim - 1)), keepdim=True,
                    correction=0) + 1e-8
    return err / var


def load_loss(name: str, **kw) -> Callable:
    """Look up a loss by config key (reference: credit/losses/__init__.py:176)."""
    fn = registry.get("loss", name)
    return functools.partial(fn, **kw) if kw else fn


def is_crps_loss(name: str) -> bool:
    return "crps" in name.lower() or name == "KCRPS"


class WeightedLoss:
    """Latitude- and variable-weighted total loss with optional spectral and
    power terms (reference: VariableTotalLoss2D,
    credit/losses/weighted_loss.py:85).

    Args:
      base: loss key, e.g. 'mse' or 'almost-fair-crps'.
      lat_weights: (nlat,) cos-lat weights normalized to mean 1, or None.
      var_weights: (C,) per-channel weights, or None.
      spectral_lambda / power_lambda: the terms' coefficients (0 disables;
        validation losses take neither).
    `is_ensemble` says whether the base is of the CRPS family, whose
    prediction carries the ensemble axis.
    """

    def __init__(self, base: str = "mse", lat_weights=None, var_weights=None,
                 spectral_lambda: float = 0.0, power_lambda: float = 0.0,
                 wavenum_init: int = 20, validation: bool = False, **base_kw):
        self.base_name = base
        self.base = load_loss(base, **base_kw)
        self.lat_weights = None if lat_weights is None else torch.as_tensor(
            np.asarray(lat_weights, np.float32))
        self.var_weights = None if var_weights is None else torch.as_tensor(
            np.asarray(var_weights, np.float32))
        self.spectral_lambda = 0.0 if validation else spectral_lambda
        self.power_lambda = 0.0 if validation else power_lambda
        self.wavenum_init = wavenum_init
        self.is_ensemble = is_crps_loss(base)

    @classmethod
    def from_config(cls, conf: dict, grid=None, validation: bool = False) -> "WeightedLoss":
        """From the config's `loss` section. `grid` gives the latitude weights
        through its `coslat_weights()`, as credit_tpu's Grid does."""
        if cls is WeightedLoss and "datasets" in (conf.get("data") or {}):
            return DownscalingLoss.from_config(conf, grid, validation)
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
        """target: (B, T, lat, lon, C); pred the same, or (B, E, T, lat,
        lon, C) for a CRPS-family base. Returns a scalar; the spectral and
        power terms score the member mean."""
        field = self.base(target, pred)
        lat_w = None if self.lat_weights is None else self.lat_weights.to(field.device)
        if lat_w is not None:
            field = field * lat_w[:, None, None]
        if self.var_weights is not None:
            field = field * self.var_weights.to(field.device)
        loss = torch.mean(field)
        p2 = pred if pred.dim() == target.dim() else pred.mean(dim=1)
        if self.power_lambda:
            loss = loss + self.power_lambda * power_loss(target, p2, lat_w, self.wavenum_init)
        if self.spectral_lambda:
            loss = loss + self.spectral_lambda * spectral_loss(target, p2, lat_w,
                                                               self.wavenum_init)
        return loss


class DownscalingLoss(WeightedLoss):
    """The loss of regional-downscaling configs (`data.datasets`): the base
    loss on the target grid without latitude weights (a regional grid is
    not a global graticule; asking for them warns), validation with
    `validation_loss` (default L1) unless training takes a CRPS-family
    loss, which then validates too."""

    @classmethod
    def from_config(cls, conf: dict, grid=None, validation: bool = False) -> "DownscalingLoss":
        import warnings

        lconf = dict(conf.get("loss", {}))
        if lconf.get("use_latitude_weights"):
            warnings.warn("latitude weights not applicable to downscaling")
        train_base = lconf.get("training_loss", "mse")
        if validation and not is_crps_loss(train_base):
            base = lconf.get("validation_loss", "mae")
        else:
            base = train_base
        lam = lconf.get("spectral_lambda_reg", 0.0)
        return cls(base=base, spectral_lambda=lam if lconf.get("use_spectral_loss") else 0.0,
                   power_lambda=lam if lconf.get("use_power_loss") else 0.0,
                   wavenum_init=lconf.get("spectral_wavenum_init", 20), validation=validation)

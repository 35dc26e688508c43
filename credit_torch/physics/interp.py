"""Vertical interpolation and column diagnostics (port of
credit_tpu/physics/interp.py; reference: credit/interp.py --
fast_state_interp_loop:224, create_pressure_grid:369,
geopotential_from_model_vars:430, interp_hybrid_to_pressure_levels:482,
mean_sea_level_pressure:731; credit/postblock/geopotential.py:9-86 and
credit/postblock/mslp.py).

The reference's per-column loops are batched: every column's knots are
searched at once (`torch.searchsorted` over the flattened columns, side
'left' as jnp.searchsorted's default) and the brackets read by
`torch.gather`.

Layout: level is the LAST axis; fields (..., lat, lon[, lev]). Levels are
ordered top of atmosphere -> surface (pressure increasing).
"""

from __future__ import annotations

from typing import Tuple

import torch

from credit_torch.physics.constants import GRAVITY, RDGAS, RVGAS

_GAMMA_VT = RVGAS / RDGAS - 1.0
_LAPSE_RATE = 0.0065
_ALPHA_STD = _LAPSE_RATE * RDGAS / GRAVITY
_T_WARM = 290.5
_T_COLD = 255.0


def _as(t, like: torch.Tensor) -> torch.Tensor:
    """A constant (array, list or tensor) as a float32 tensor on like's device."""
    return torch.as_tensor(t, dtype=torch.float32, device=like.device)


def pressure_on_interfaces(sp, a_half, b_half, model_top_pressure: float = 0.57):
    """p_half = a + b * SP on interfaces; clamped at model top
    (reference: postblock/geopotential.py:9). sp (..., H, W) ->
    (..., H, W, L+1)."""
    p = _as(a_half, sp) + _as(b_half, sp) * sp[..., None]
    return torch.where(p > 0, p, torch.full_like(p, model_top_pressure))


def geopotential_hybrid(surface_geopotential, sp, t, q, a_half, b_half):
    """Geopotential on model levels by hypsometric integration from the
    surface (reference: postblock/geopotential.py:37 geopotential).

    t, q: (..., H, W, L) with level 0 = model top; returns the same shape.
    """
    p_half = pressure_on_interfaces(sp, a_half, b_half)  # (..., L+1)
    pi_upper = p_half[..., :-1]
    pi_lower = p_half[..., 1:]
    dlogp = torch.log(pi_lower / pi_upper)
    alpha = 1.0 - (pi_upper / (pi_lower - pi_upper)) * dlogp
    tv = t * (1.0 + _GAMMA_VT * q)
    # integrate from the surface upward: the cumulative sum of R Tv dlogp
    # taken from the bottom level
    contrib = RDGAS * tv * dlogp
    below = torch.flip(torch.cumsum(torch.flip(contrib, [-1]), dim=-1), [-1])
    geo_lower_iface = _as(surface_geopotential, sp)[..., None] + below - contrib
    # ECMWF convention: phi_center = phi_lower_interface + alpha R Tv
    return geo_lower_iface + RDGAS * tv * alpha


def mslp_trenberth(sp, t, surface_geopotential):
    """Trenberth et al. (1993) mean sea level pressure (reference:
    postblock/mslp.py mslp_from_surface_pressure, with its
    geopotential -> height fix)."""
    sgp = _as(surface_geopotential, t)
    height = sgp / GRAVITY
    near_flat = torch.abs(height) < 1e-4
    tto = t + _LAPSE_RATE * height

    mask1 = (t <= _T_WARM) & (tto > _T_WARM)
    mask2 = t > _T_WARM
    mask3 = (t < _T_COLD) & ~mask1 & ~mask2

    alpha = torch.full_like(t, _ALPHA_STD)
    alpha = torch.where(mask1, RDGAS * (_T_WARM - t) / torch.clamp(sgp, min=1e-6), alpha)
    alpha = torch.where(mask2, torch.zeros_like(alpha), alpha)
    t_eff = torch.where(mask2, 0.5 * (_T_WARM + t), t)
    t_eff = torch.where(mask3, 0.5 * (_T_COLD + t), t_eff)

    x = sgp / (RDGAS * torch.clamp(t_eff, min=1.0))
    mslp = sp * torch.exp(x * (1.0 - 0.5 * alpha * x + (alpha * x) ** 2 / 3.0))
    return torch.where(near_flat, sp, mslp)


def _interp_monotonic(xq, x, y, use_log: bool = True):
    """Per-column linear interp of y(x) at xq over the LAST axis, x increasing.

    x: (..., L); y: (..., L); xq: (..., K) -> (..., K), the leading dims
    the same. Clamps outside the column's range.
    """
    if use_log:
        x = torch.log(x)
        xq = torch.log(xq)
    n = x.shape[-1]
    rows = x.reshape(-1, n).contiguous()
    idx = torch.searchsorted(rows, xq.reshape(-1, xq.shape[-1]).contiguous())
    idx = idx.clamp(1, n - 1).reshape(xq.shape)
    x0 = torch.gather(x, -1, idx - 1)
    x1 = torch.gather(x, -1, idx)
    y0 = torch.gather(y, -1, idx - 1)
    y1 = torch.gather(y, -1, idx)
    w = torch.clamp((xq - x0) / (x1 - x0), 0.0, 1.0)
    return y0 + w * (y1 - y0)


def interp_hybrid_to_pressure(var, model_pressure, pressure_levels, use_log: bool = True):
    """Model levels -> fixed pressure levels (reference
    interp_hybrid_to_pressure_levels:482). var, model_pressure: (..., L);
    pressure_levels: (K,)."""
    pl = _as(pressure_levels, var)
    pq = pl.expand(*var.shape[:-1], pl.shape[0])
    return _interp_monotonic(pq, model_pressure.expand_as(var), var, use_log)


def interp_pressure_to_hybrid(var, pressure_levels, model_pressure, use_log: bool = True):
    """Fixed pressure levels -> model levels (reference :517)."""
    pl = _as(pressure_levels, var)
    x = pl.expand(*model_pressure.shape[:-1], pl.shape[0])
    return _interp_monotonic(model_pressure, x, var, use_log)


def interp_hybrid_to_hybrid(var, pressure_in, pressure_out, use_log: bool = True):
    """Arbitrary column-to-column re-leveling (reference :546)."""
    return _interp_monotonic(pressure_out, pressure_in, var, use_log)


def create_pressure_grid(sp, a_half, b_half) -> Tuple[torch.Tensor, torch.Tensor]:
    """(half_pressure (..., L+1), full_pressure (..., L)) -- reference :369
    (full levels as interface means)."""
    half = pressure_on_interfaces(sp, a_half, b_half)
    full = 0.5 * (half[..., :-1] + half[..., 1:])
    return half, full


def interp_temperature_to_pressure(t, model_pressure, pressure_levels, sp, sgp,
                                   use_log: bool = True):
    """T to pressure levels with ECMWF below-ground lapse-rate extrapolation
    (reference interp_temperature_to_pressure_levels:638)."""
    base = interp_hybrid_to_pressure(t, model_pressure, pressure_levels, use_log)
    t_sfc = t[..., -1]
    p_sfc = model_pressure[..., -1]
    pl = _as(pressure_levels, t)
    t_extrap = t_sfc[..., None] * (pl / p_sfc[..., None]) ** _ALPHA_STD
    below = pl > p_sfc[..., None]
    return torch.where(below, t_extrap, base)


def interp_geopotential_to_pressure(z, model_pressure, pressure_levels, sp, sgp, t_sfc,
                                    use_log: bool = True):
    """Geopotential to pressure levels with hydrostatic below-ground
    extrapolation (reference interp_geopotential_to_pressure_levels:572)."""
    base = interp_hybrid_to_pressure(z, model_pressure, pressure_levels, use_log)
    pl = _as(pressure_levels, z)
    p_sfc = model_pressure[..., -1]
    # hydrostatic: phi(p) = phi_sfc - R T_sfc ln(p / p_sfc)
    z_extrap = (_as(sgp, z)[..., None]
                - RDGAS * t_sfc[..., None] * torch.log(pl / p_sfc[..., None]))
    below = pl > p_sfc[..., None]
    return torch.where(below, z_extrap, base)

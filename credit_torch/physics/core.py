"""Vertical pressure integrals and column thermodynamics (port of
credit_tpu/physics/core.py; reference: credit/physics_core.py --
physics_pressure_level:75, physics_hybrid_sigma_level:300,
ModelLevelPressures:36, total_dry_air_mass:500, total_column_water:510).

Layout: level is the LAST axis -- (..., lat, lon, lev) -- as in the
reference, so vertical reductions broadcast against flat channels-last
tensors. The coefficients and cell areas are f32 tensors made on the CPU;
`to(device)` moves them to the inputs' device (the fixers call it at each
step, a no-op once they are there).
"""

from __future__ import annotations

import torch

from credit_torch.physics.constants import CP_DRY, CP_VAPOR, EPSGAS, GRAVITY, LH_WATER, RDGAS


def virtual_temperature(t, q):
    """T_v from temperature and specific humidity (metpy convention,
    reference physics_core.py:29)."""
    w = q / (1.0 - q)
    return t * (w + EPSGAS) / (EPSGAS * (1.0 + w))


def density(p, t, q):
    return p / (RDGAS * virtual_temperature(t, q))


def model_level_pressures(sp, ak, bk):
    """p_lev = ak + bk * sp; sp (..., lat, lon) -> (..., lat, lon, L)."""
    return ak + bk * sp[..., None]


def half_level_pressures(plevs):
    """Geometric-mean half levels (reference ModelLevelPressures.compute_hlevs)."""
    return torch.exp(0.5 * (torch.log(plevs[..., :-1]) + torch.log(plevs[..., 1:])))


def model_level_thickness(sp, ak, bk):
    """Pressure thickness per model level: diff of half levels padded with
    (0, sp) (reference compute_mlev_thickness)."""
    plevs = model_level_pressures(sp, ak, bk)
    hlevs = half_level_pressures(plevs)
    top = torch.zeros_like(sp)[..., None]
    bot = sp[..., None]
    full = torch.cat([top, hlevs, bot], dim=-1)
    return torch.diff(full, dim=-1)


def pressure_integral_midpoint(q_mid, delta_p):
    """sum(q_mid * delta_p) over the last (level) axis."""
    return torch.sum(q_mid * delta_p, dim=-1)


def pressure_integral_trapz(q, delta_p):
    """Trapezoidal: 0.5 * (q[k] + q[k+1]) * delta_p[k], summed."""
    return torch.sum(0.5 * (q[..., :-1] + q[..., 1:]) * delta_p, dim=-1)


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


class _Physics:
    area: torch.Tensor

    def to(self, device) -> "_Physics":
        """Move the coefficient and area tensors to `device` (in place)."""
        for name, v in vars(self).items():
            if isinstance(v, torch.Tensor):
                setattr(self, name, v.to(device))
        return self

    def weighted_sum(self, q, axis=(-2, -1), keepdims=False):
        return torch.sum(q * self.area, dim=axis, keepdim=keepdims)


class PressureLevelPhysics(_Physics):
    """Fixed pressure-level grid (reference physics_pressure_level)."""

    def __init__(self, grid, pressure_levels, midpoint: bool = False):
        self.grid = grid
        self.p = _f32(pressure_levels)
        self.delta_p = torch.diff(self.p)
        self.area = _f32(grid.cell_area())
        self.midpoint = midpoint

    def integral(self, q):
        if self.midpoint:
            return pressure_integral_midpoint(q, self.delta_p)
        return pressure_integral_trapz(q, self.delta_p)

    def total_dry_air_mass(self, q):
        """Global dry-air mass [kg]; q: (..., lat, lon, lev) specific water."""
        mass_per_area = self.integral(1.0 - q) / GRAVITY
        return self.weighted_sum(mass_per_area)

    def total_column_water(self, q):
        return self.integral(q) / GRAVITY


class HybridSigmaPhysics(_Physics):
    """Hybrid sigma-pressure grid (reference physics_hybrid_sigma_level)."""

    def __init__(self, grid, ak, bk, midpoint: bool = False):
        self.grid = grid
        self.ak = _f32(ak)
        self.bk = _f32(bk)
        self.area = _f32(grid.cell_area())
        self.midpoint = midpoint

    def pressure(self, sp):
        return model_level_pressures(sp, self.ak, self.bk)

    def integral(self, q, sp):
        p = self.pressure(sp)
        delta_p = torch.diff(p, dim=-1)
        if self.midpoint:
            return pressure_integral_midpoint(q, delta_p)
        return pressure_integral_trapz(q, delta_p)

    def total_dry_air_mass(self, q, sp):
        mass_per_area = self.integral(1.0 - q, sp) / GRAVITY
        return self.weighted_sum(mass_per_area)

    def total_column_water(self, q, sp):
        return self.integral(q, sp) / GRAVITY

    def total_energy(self, t, q, u, v, sp, surface_geopotential):
        """Column-integrated moist static + kinetic energy [J/m^2]
        (reference: conservation.py GlobalEnergyFixerUpDown.forward)."""
        cp = (1.0 - q) * CP_DRY + q * CP_VAPOR
        e = cp * t + LH_WATER * q + surface_geopotential[..., None] + 0.5 * (u**2 + v**2)
        return self.integral(e, sp) / GRAVITY

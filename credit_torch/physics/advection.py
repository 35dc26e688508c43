"""Semi-Lagrangian advection on the hybrid-sigma lat-lon grid (port of
credit_tpu/physics/advection.py).

The reference's advection engine (reference: credit/postblock/advect.py --
horizontal_divergence:85, omega_from_continuity:121, trilinear grid_sample
departure interpolation :162-203, _SemiLagrangianAdvectionEngine:206):
spherical horizontal divergence, kinematic omega integrated from the model
top, iterative-midpoint back-trajectories in grid-index space, and
trilinear departure-point interpolation with circular longitude wrapping.
Departure sampling is 8 `torch.gather`s on int64 indices with floor-mod
longitude (`torch.remainder`), no halo copy.

Layout: fields are (N, H, W, L) -- level LAST, ordered top -> surface.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from credit_torch.ops.regrid import _Tables
from credit_torch.physics.constants import RAD_EARTH


def _row_gradient(f: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.gradient with unit spacing: centred inside, one-sided at the
    ends."""
    return torch.gradient(f, dim=dim, edge_order=1)[0]


def horizontal_divergence(u, v, lat_rad, dlon_rad, radius=RAD_EARTH, coslat_floor=1e-4):
    """div = 1/(a cosφ) [∂u/∂λ + ∂(v cosφ)/∂φ]; u, v (N, H, W, L)."""
    coslat = torch.cos(lat_rad)[:, None, None]
    cos_safe = torch.clamp(coslat, min=coslat_floor)
    dudlon = (torch.roll(u, -1, dims=-2) - torch.roll(u, 1, dims=-2)) / (2.0 * dlon_rad)
    vcos = v * coslat
    # centred differences on (possibly non-uniform) latitude, one-sided at
    # the poles: unit-spacing differences divided by each row's spacing
    dlat = _row_gradient(lat_rad, 0)
    dvdlat = _row_gradient(vcos, -3) / dlat[:, None, None]
    return (dudlon + dvdlat) / (radius * cos_safe)


def omega_from_continuity(u, v, p_half, lat_rad, dlon_rad, radius=RAD_EARTH,
                          coslat_floor=1e-4):
    """Kinematic ω = dp/dt at level centres (Pa/s); p_half (N, H, W, L+1)."""
    div = horizontal_divergence(u, v, lat_rad, dlon_rad, radius, coslat_floor)
    dp = p_half[..., 1:] - p_half[..., :-1]
    flux = torch.cumsum(div * dp, dim=-1)
    omega_lower = -flux
    omega_upper = torch.cat([torch.zeros_like(flux[..., :1]), -flux[..., :-1]], dim=-1)
    return 0.5 * (omega_upper + omega_lower)


def trilinear_sample(vol: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                     lev: torch.Tensor) -> torch.Tensor:
    """Sample vol (N, H, W, L) at fractional (row, col, lev) -- each
    (N, H, W, L). Longitude wraps (circular); lat and level clamp."""
    n, h, w, L = vol.shape
    row = torch.clamp(row, 0.0, h - 1.0)
    lev = torch.clamp(lev, 0.0, L - 1.0) if L > 1 else torch.zeros_like(lev)
    col = torch.remainder(col, w)
    # a column just below 0 rounds to exactly w in f32 (jnp.mod too): that
    # point is column 0. credit_tpu reads the next row's first column there
    # (NaN past the last row); the port reads column 0, and no index leaves
    # the volume (an out-of-range gather is an error on the card)
    col = torch.where(col >= w, col - w, col)

    r0 = torch.floor(row).long()
    c0 = torch.floor(col).long()
    l0 = torch.floor(lev).long()
    r1 = torch.clamp(r0 + 1, 0, h - 1)
    c1 = torch.remainder(c0 + 1, w)
    l1 = torch.clamp(l0 + 1, 0, L - 1)
    wr = row - r0
    wc = col - c0
    wl = lev - l0

    flat = vol.reshape(n, -1)

    def gather(ri, ci, li):
        idx = (ri * w + ci) * L + li
        return torch.gather(flat, 1, idx.reshape(n, -1)).reshape(ri.shape)

    v000 = gather(r0, c0, l0)
    v001 = gather(r0, c0, l1)
    v010 = gather(r0, c1, l0)
    v011 = gather(r0, c1, l1)
    v100 = gather(r1, c0, l0)
    v101 = gather(r1, c0, l1)
    v110 = gather(r1, c1, l0)
    v111 = gather(r1, c1, l1)

    v00 = v000 * (1 - wl) + v001 * wl
    v01 = v010 * (1 - wl) + v011 * wl
    v10 = v100 * (1 - wl) + v101 * wl
    v11 = v110 * (1 - wl) + v111 * wl
    v0 = v00 * (1 - wc) + v01 * wc
    v1 = v10 * (1 - wc) + v11 * wc
    return v0 * (1 - wr) + v1 * wr


class SemiLagrangianAdvection(_Tables):
    """One advection step for a set of tracers. Args mirror the reference
    engine (advect.py:206): hybrid a/b half-level coefficients, the grid's
    latitudes, the timestep, midpoint iterations. The constant tensors
    follow the winds' device at the first call."""

    _tables = ("lat_rad", "a_half", "b_half")

    def __init__(self, grid, a_half, b_half, timestep_seconds: float = 21600.0,
                 n_iterations: int = 2, coslat_floor: float = 1e-4,
                 dp_dlevel_floor: float = 1.0):
        self.lat_rad = torch.from_numpy(np.deg2rad(grid.lat).astype(np.float32))
        self.dlon_rad = float(np.deg2rad(360.0 / grid.nlon))
        self.a_half = torch.as_tensor(np.asarray(a_half, np.float32))
        self.b_half = torch.as_tensor(np.asarray(b_half, np.float32))
        self.dt = timestep_seconds
        self.n_iterations = n_iterations
        self.coslat_floor = coslat_floor
        self.dp_dlevel_floor = dp_dlevel_floor

    def departure_indices(self, u, v, sp) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """u, v: (N, H, W, L); sp: (N, H, W). Returns the fractional
        departure (row, col, lev) index fields."""
        self._on(u.device)
        n, h, w, L = u.shape
        p_half = self.a_half + self.b_half * sp[..., None]  # (N, H, W, L+1)
        p_center = 0.5 * (p_half[..., :-1] + p_half[..., 1:])
        if L == 1:
            omega = torch.zeros_like(u)
        else:
            omega = omega_from_continuity(u, v, p_half, self.lat_rad, self.dlon_rad,
                                          coslat_floor=self.coslat_floor)

        cos_safe = torch.clamp(torch.cos(self.lat_rad), min=self.coslat_floor)[:, None, None]
        dlat_row = _row_gradient(self.lat_rad, 0)[:, None, None]
        vel_col = u / (RAD_EARTH * cos_safe) / self.dlon_rad
        vel_row = v / RAD_EARTH / dlat_row
        if L > 1:
            dp_dlev = torch.clamp(_row_gradient(p_center, -1), min=self.dp_dlevel_floor)
            vel_lev = omega / dp_dlev
        else:
            vel_lev = torch.zeros_like(u)

        row0 = torch.arange(h, dtype=u.dtype, device=u.device)[None, :, None, None].expand_as(u)
        col0 = torch.arange(w, dtype=u.dtype, device=u.device)[None, None, :, None].expand_as(u)
        lev0 = torch.arange(L, dtype=u.dtype, device=u.device)[None, None, None, :].expand_as(u)

        disp_r = torch.zeros_like(u)
        disp_c = torch.zeros_like(u)
        disp_l = torch.zeros_like(u)
        for _ in range(self.n_iterations):
            mid_r = row0 - 0.5 * disp_r
            mid_c = col0 - 0.5 * disp_c
            mid_l = lev0 - 0.5 * disp_l
            disp_c = self.dt * trilinear_sample(vel_col, mid_r, mid_c, mid_l)
            disp_r = self.dt * trilinear_sample(vel_row, mid_r, mid_c, mid_l)
            disp_l = self.dt * trilinear_sample(vel_lev, mid_r, mid_c, mid_l)
        return row0 - disp_r, col0 - disp_c, lev0 - disp_l

    def advect(self, tracers: Sequence[torch.Tensor], u, v, sp):
        """Advect each (N, H, W, L) tracer one timestep; returns a list."""
        dep_r, dep_c, dep_l = self.departure_indices(u, v, sp)
        return [trilinear_sample(t, dep_r, dep_c, dep_l) for t in tracers]

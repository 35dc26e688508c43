"""Real spherical harmonic transforms as batched matmuls + rFFT (the port of
credit_tpu/ops/sht.py).

A replacement for torch-harmonics (the reference's SHT dependency —
reference: credit/pol_lapdiff_filt.py:151-162 grid2spec/spec2grid,
credit/skebs.py:447-458, credit/ensemble/spherical.py). The longitude
transform is `torch.fft.rfft` / `irfft`; the latitude transform contracts
against precomputed associated-Legendre tables, one real batched product
per order m (`torch.bmm` over the real and imaginary parts as columns), so
no table is ever cast to complex.

Conventions (matching torch-harmonics defaults): orthonormal spherical
harmonics with Condon-Shortley phase; grids 'equiangular' (trapezoid/CC
quadrature) or 'legendre-gauss'. Tables are built in float64 by
credit_tpu's recurrences, in the same order of operations, one degree l at
a time over every order m, and each row is stored float32 as it is made:
the same float32 values, without credit_tpu's (mmax, lmax, nlat) float64
tables (3.0 GB each at 721 latitudes). An SHT on a CUDA device builds its
tables there, op for op as numpy does on the host (each operation one
IEEE-rounded elementwise kernel, no fused multiply-add), so the same
values; on the CPU numpy builds them.

Memory: three float32 tables of (mmax, lmax, nlat), 1.5 GB each at 0.25
degrees (721 latitudes, 1440 longitudes), on the SHT's device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from credit_torch.physics.constants import RAD_EARTH


def _legendre_rows(lmax: int, mmax: int, x: np.ndarray, device=None):
    """(l, P̄_l^m(x), dP̄_l^m/dθ) for l = 0..lmax-1, each an (mmax, nlat)
    float64 array over every order m, zero where m > l: numpy arrays, or
    torch tensors on `device` where one is given (the coefficients over m
    are made by numpy either way).

    credit_tpu's `_legendre_table` recurrence (P̄ normalized so that
    ∫_{-1}^{1} P̄_l^m P̄_l'^m dx = δ_ll', Condon-Shortley phase) and its
    `_dlegendre_dtheta` (dP̄/dθ = (-l x P̄_l^m + c P̄_{l-1}^m) / sinθ,
    c = sqrt((l^2-m^2)(2l+1)/(2l-1))), element by element the same
    operations in the same order, with the sequential loop over l instead
    of (m, l)."""
    if device is None:
        put, zeros = (lambda a: a), np.zeros
    else:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(device)

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float64, device=device)
    nlat = x.shape[0]
    # P̄_m^m via the stable product form
    pmm = np.empty((mmax, nlat))
    p = np.full(nlat, 1.0 / np.sqrt(2.0))  # P̄_0^0 = 1/sqrt(2)
    sx = np.sqrt(np.maximum(0.0, 1.0 - x * x))
    for m in range(mmax):
        if m > 0:
            p = -np.sqrt((2 * m + 1) / (2.0 * m)) * sx * p
        pmm[m] = p
    sxd = put(np.sqrt(np.maximum(1e-12, 1.0 - x * x)))
    ms = np.arange(mmax)
    x, pmm = put(x), put(pmm)
    prev2 = prev1 = zeros((mmax, nlat))
    for l in range(lmax):
        row = zeros((mmax, nlat))
        k = max(0, min(l - 1, mmax))  # orders m <= l - 2: the upward recurrence
        if k:
            m = ms[:k]
            a = put(np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m)))
            b = put(np.sqrt(((2.0 * l + 1.0) * ((l - 1.0) ** 2 - m * m))
                            / ((2.0 * l - 3.0) * (l * l - m * m))))
            row[:k] = a[:, None] * x * prev1[:k] - b[:, None] * prev2[:k]
        if 0 <= l - 1 < mmax:
            row[l - 1] = float(np.sqrt(2 * (l - 1) + 3.0)) * x * pmm[l - 1]
        if l < mmax:
            row[l] = pmm[l]
        drow = zeros((mmax, nlat))
        k = min(l + 1, mmax)  # orders m <= l
        m = ms[:k]
        c = put(np.sqrt((l * l - m * m) * (2.0 * l + 1.0) / max(2.0 * l - 1.0, 1.0)))
        drow[:k] = (-l * x * row[:k] + c[:, None] * prev1[:k]) / sxd
        yield l, row, drow
        prev2, prev1 = prev1, row


def _legendre_table(lmax: int, mmax: int, x: np.ndarray) -> np.ndarray:
    """Normalized associated Legendre P̄_l^m(x), shape (mmax, lmax, nlat),
    float64."""
    out = np.zeros((mmax, lmax, x.shape[0]))
    for l, row, _ in _legendre_rows(lmax, mmax, x):
        out[:, l] = row
    return out


def _dlegendre_dtheta(lmax: int, mmax: int, x: np.ndarray) -> np.ndarray:
    """d P̄_l^m / dθ where x = cosθ, shape (mmax, lmax, nlat), float64."""
    out = np.zeros((mmax, lmax, x.shape[0]))
    for l, _, drow in _legendre_rows(lmax, mmax, x):
        out[:, l] = drow
    return out


def _tables(lmax: int, mmax: int, x: np.ndarray, w: np.ndarray, device=None):
    """The three float32 (mmax, lmax, nlat) tables of an SHT, as credit_tpu
    stores them: P̄ (synthesis), P̄·w rounded once from float64 (analysis)
    and dP̄/dθ; numpy arrays, or tensors built on `device` where one is
    given."""
    shape = (mmax, lmax, x.shape[0])
    if device is None:
        pct, pw, dpct = (np.empty(shape, np.float32) for _ in range(3))
    else:
        pct, pw, dpct = (torch.empty(shape, dtype=torch.float32, device=device)
                         for _ in range(3))
        w = torch.from_numpy(np.asarray(w, np.float64)).to(device)
    for l, row, drow in _legendre_rows(lmax, mmax, x, device):
        pct[:, l] = row
        pw[:, l] = row * w
        dpct[:, l] = drow
    return pct, pw, dpct


def _quadrature(lat_deg: np.ndarray, grid: str) -> np.ndarray:
    """Quadrature weights over x = sin(lat) for the latitude sum."""
    nlat = lat_deg.shape[0]
    if grid == "legendre-gauss":
        xg, wg = np.polynomial.legendre.leggauss(nlat)
        return wg  # caller must use the matching gauss latitudes
    # equiangular incl. poles: Clenshaw-Curtis-style weights via exact
    # integration of the trapezoid basis over sin(lat)
    lat = np.deg2rad(lat_deg)
    order = np.argsort(lat)
    ls = lat[order]
    edges = np.empty(nlat + 1)
    edges[1:-1] = 0.5 * (ls[:-1] + ls[1:])
    edges[0] = -np.pi / 2
    edges[-1] = np.pi / 2
    w_sorted = np.sin(edges[1:]) - np.sin(edges[:-1])
    w = np.empty(nlat)
    w[order] = w_sorted
    return w


def _contract(f: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[..., i, m] = Σ_j f[..., j, m] table[m, i, j] for complex f and a
    real (M, I, J) table: per order m one real product of the table with
    the batch's real and imaginary parts as columns."""
    *batch, nj, nm = f.shape
    cols = torch.view_as_real(f).reshape(-1, nj, nm, 2).permute(2, 1, 0, 3).reshape(nm, nj, -1)
    out = torch.bmm(table, cols)  # (M, I, N*2)
    out = out.reshape(nm, table.shape[1], -1, 2).permute(2, 1, 0, 3).contiguous()
    return torch.view_as_complex(out).reshape(*batch, table.shape[1], nm)


class SHT:
    """Scalar real SHT pair + spectral derivative helpers, float32 tables on
    `device`; fields on the same device."""

    def __init__(self, lat_deg: np.ndarray, nlon: int,
                 lmax: Optional[int] = None, mmax: Optional[int] = None,
                 grid: str = "equiangular", radius: float = RAD_EARTH,
                 device="cpu"):
        self.nlat = int(lat_deg.shape[0])
        self.nlon = int(nlon)
        self.lmax = lmax or self.nlat
        self.mmax = mmax or min(self.lmax, nlon // 2 + 1)
        self.grid = grid
        self.radius = radius
        device = torch.device(device)
        x = np.sin(np.deg2rad(np.asarray(lat_deg, np.float64)))
        w = _quadrature(np.asarray(lat_deg, np.float64), grid)
        # analysis folds in the quadrature weights; 2π from the lon integral
        # and 1/(2π) of the Y normalization cancel into 2π/nlon, handled by
        # the fft scaling below
        if device.type == "cuda":
            self.pct, self.pw, self.dpct = _tables(self.lmax, self.mmax, x, w, device)
        else:
            self.pct, self.pw, self.dpct = (
                torch.from_numpy(t).to(device) for t in _tables(self.lmax, self.mmax, x, w))
        self.w = torch.from_numpy(w.astype(np.float32)).to(device)
        self.coslat = torch.from_numpy(
            np.asarray(np.cos(np.deg2rad(lat_deg)), np.float32)).to(device)
        ls = np.arange(self.lmax)
        self.laplacian = torch.from_numpy(
            (-ls * (ls + 1.0) / radius**2).astype(np.float32)).to(device)
        self.m = torch.arange(self.mmax, device=device)

    def to(self, device) -> "SHT":
        """Move the tables to `device` (where they are not already) and
        return self: the blocks that hold an SHT move it to their field's
        device at the first call."""
        device = torch.device(device)
        for name in ("pct", "pw", "dpct", "w", "coslat", "laplacian", "m"):
            t = getattr(self, name)
            if t.device != device:
                setattr(self, name, t.to(device))
        return self

    # ------------------------------------------------------------------
    def _fourier(self, f: torch.Tensor) -> torch.Tensor:
        return torch.fft.rfft(f, dim=-1)[..., :self.mmax] * (2.0 * math.pi / self.nlon)

    def _ifft(self, fm: torch.Tensor) -> torch.Tensor:
        full = torch.zeros((*fm.shape[:-1], self.nlon // 2 + 1), dtype=fm.dtype,
                           device=fm.device)
        full[..., :self.mmax] = fm
        return torch.fft.irfft(full, n=self.nlon, dim=-1) * (self.nlon / (2.0 * math.pi))

    def grid2spec(self, f: torch.Tensor) -> torch.Tensor:
        """f: (..., nlat, nlon) real -> (..., lmax, mmax) complex."""
        return _contract(self._fourier(f), self.pw)

    def spec2grid(self, flm: torch.Tensor) -> torch.Tensor:
        """(..., lmax, mmax) complex -> (..., nlat, nlon) real."""
        return self._ifft(_contract(flm, self.pct.transpose(1, 2)))

    # ------------------------------------------------------------------
    def filter(self, f: torch.Tensor, response) -> torch.Tensor:
        """Apply a per-degree spectral response r(l): (..., lat, lon) real."""
        flm = self.grid2spec(f)
        return self.spec2grid(flm * torch.as_tensor(response, device=flm.device)[:, None])

    def laplacian_grid(self, f: torch.Tensor) -> torch.Tensor:
        return self.spec2grid(self.grid2spec(f) * self.laplacian[:, None])

    def inverse_laplacian(self, flm: torch.Tensor) -> torch.Tensor:
        lap = self.laplacian
        inv = torch.where(lap != 0, 1.0 / lap, torch.zeros_like(lap))
        return flm * inv[:, None]

    # ------------------------------------------------------------------
    def grad_from_spec(self, flm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """∇f on the grid from spectral f: returns (df/dx_east, df/dy_north).

        east  = (1 / (R cosθ)) ∂f/∂λ ;  north = (1/R) ∂f/∂θ with θ latitude.
        """
        dlam = self._ifft(_contract(flm * (1j * self.m)[None, :], self.pct.transpose(1, 2)))
        east = dlam / (self.radius * torch.clamp(self.coslat, min=1e-6)[..., :, None])
        north = self._ifft(_contract(flm, self.dpct.transpose(1, 2))) / self.radius
        return east, north

    def uv_from_streamfunction(self, psi_lm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(u, v) = k x ∇ψ: u = -(1/R) ∂ψ/∂θ, v = (1/(R cosθ)) ∂ψ/∂λ.

        This is the SKEBS perturbation path (reference: credit/skebs.py:775
        getuv applied to the rotational streamfunction forcing).
        """
        east, north = self.grad_from_spec(psi_lm)
        return -north, east

    def vrtdiv_spec(self, u: torch.Tensor, v: torch.Tensor):
        """(vrt_lm, div_lm) of a horizontal wind field.

        div = (1/(R cosθ))[∂u/∂λ + ∂(v cosθ)/∂θ]
        vrt = (1/(R cosθ))[∂v/∂λ − ∂(u cosθ)/∂θ]
        The θ terms are evaluated by integration by parts against dP̄/dθ
        (no pole boundary terms since cosθ -> 0 there):
          ∫ (1/cosθ) ∂(f cosθ)/∂θ Y* dΩ = −Σ_j (w_j/cosθ_j) dP̄/dθ(j) f_m(j).
        u and v go through each table together.
        """
        uvm = self._fourier(torch.stack([u, v]))
        cos = torch.clamp(self.coslat, min=1e-6)
        a_u, a_v = _contract(uvm / cos[:, None], self.pw) * (1j * self.m)[None, :]
        # ∫ f cosφ ∂Y*/∂φ dφ dλ: the cosφ of dΩ cancels the 1/cosφ of the
        # operator, leaving plain quadrature weights against dP̄/dφ (folded
        # into the Fourier coefficients, so no dP̄/dθ·w table is kept)
        theta_u, theta_v = _contract(uvm * self.w[:, None], self.dpct)
        div = (a_u - theta_v) / self.radius
        vrt = (a_v + theta_u) / self.radius
        return vrt, div

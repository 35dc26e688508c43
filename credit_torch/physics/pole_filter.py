"""Polar filtering and Laplacian hyperdiffusion (port of
credit_tpu/physics/pole_filter.py).

Re-implements the reference's Diffusion_and_Pole_Filter (reference:
credit/pol_lapdiff_filt.py:89 -- polfiltT per-row lon lowpass :7,
create_sigmoid_ramp_function:47, polefilt_lap2d_V2:268 for winds, V1:329
scalars, QV1:358 moisture, diff_lap2d_filt:388) on the port's SHT
(`ops/sht.py`), whose tables move to the field's device at the first call.

Layout: fields are (..., lat, lon).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from credit_torch.ops.sht import SHT


def sigmoid_ramp(nlat: int, ramp: int) -> torch.Tensor:
    """Ones with sigmoid ramps at both ends (reference :47)."""
    arr = np.ones(nlat, np.float32)
    xs = np.linspace(-6, 6, ramp)
    s = 1.0 / (1.0 + np.exp(-xs))
    arr[:ramp] = s
    arr[-ramp:] = s[::-1]
    return torch.from_numpy(arr)


def pole_lowpass_rows(f: torch.Tensor, n_rows: int, keep_period: float = 100.0) -> torch.Tensor:
    """Lowpass the n_rows nearest each pole along longitude, zeroing the FFT
    coefficients with period < keep_period grid points (reference
    polfiltT)."""
    nlon = f.shape[-1]
    freq = np.fft.rfftfreq(nlon)
    perd = 1.0 / freq[1:]
    ind = int(np.argmin(np.abs(perd - keep_period))) + 1
    z = torch.fft.fft(f, dim=-1)
    mask = np.ones(nlon, np.float32)
    mask[ind:nlon - ind + 1] = 0.0 if 2 * ind <= nlon else 1.0
    f_low = torch.fft.ifft(z * torch.from_numpy(mask).to(f.device), dim=-1).real.to(f.dtype)
    nlat = f.shape[-2]
    row = np.zeros(nlat, np.float32)
    # rows 1..n_rows and -n_rows..-1 (the pole rows themselves excluded, as
    # the reference iterates [-n, 0) U [1, n])
    row[1:n_rows + 1] = 1.0
    row[nlat - n_rows:] = 1.0
    sel = torch.from_numpy(row).to(f.device)[:, None]
    return f * (1 - sel) + f_low * sel


class DiffusionPoleFilter:
    def __init__(self, grid, n_pole_rows: int = 10, ramp: int = 10, lmax=None, mmax=None):
        self.sht = SHT(np.asarray(grid.lat), grid.nlon, lmax=lmax, mmax=mmax,
                       grid="equiangular")
        self.sigmoid = sigmoid_ramp(grid.nlat, ramp)
        self.n_pole_rows = n_pole_rows

    def _on(self, f: torch.Tensor) -> torch.Tensor:
        """The SHT and the ramp on f's device; returns the ramp as a column."""
        self.sht.to(f.device)
        self.sigmoid = self.sigmoid.to(f.device)
        return self.sigmoid[:, None]

    def _grad(self, f_spec):
        return self.sht.grad_from_spec(f_spec)

    def _laplacian_of_grid(self, f):
        dx, dy = self._grad(self.sht.grid2spec(f))
        ddx, _ = self._grad(self.sht.grid2spec(dx))
        _, ddy = self._grad(self.sht.grid2spec(dy))
        return ddx + ddy

    def filter_winds(self, u: torch.Tensor, v: torch.Tensor, substeps: int = 6,
                     coef: float = 2e16) -> Tuple[torch.Tensor, torch.Tensor]:
        """Divergence-damping wind filter (reference polefilt_lap2d_V2):
        remove the gradient of nabla^2(divergence), masked by the lat ramp."""
        ramp = self._on(u)
        u = pole_lowpass_rows(u, self.n_pole_rows)
        v = pole_lowpass_rows(v, self.n_pole_rows)
        for _ in range(substeps):
            _, div = self.sht.vrtdiv_spec(u, v)
            ddiv_dx, ddiv_dy = self._grad(div)
            ddx2, _ = self._grad(self.sht.grid2spec(ddiv_dx))
            _, ddy2 = self._grad(self.sht.grid2spec(ddiv_dy))
            lap = ddx2 + ddy2
            dlap_dx, dlap_dy = self._grad(self.sht.grid2spec(lap))
            u = u - dlap_dx * ramp * coef
            v = v - dlap_dy * ramp * coef
        return u, v

    def filter_scalar(self, t: torch.Tensor, substeps: int = 5,
                      coef: float = 1e8) -> torch.Tensor:
        """Scalar Laplacian diffusion near the poles (reference
        polefilt_lap2d_V1)."""
        ramp = self._on(t)
        t = pole_lowpass_rows(t, self.n_pole_rows)
        for _ in range(substeps):
            t = t + self._laplacian_of_grid(t) * ramp * coef
        return t

    def filter_moisture(self, q: torch.Tensor, substeps: int = 8,
                        coef: float = 0.5e8) -> torch.Tensor:
        """Moisture variant with a gentler coefficient (reference QV1)."""
        ramp = self._on(q)
        q = pole_lowpass_rows(q, self.n_pole_rows)
        for _ in range(substeps):
            q = q + self._laplacian_of_grid(q) * ramp * coef
        return q

"""IC / model-noise generators for ensembles: port of
credit_tpu/ensemble/noise.py (reference: credit/ensemble/gaussian.py:4
GaussianNoise, spherical.py:9,146 SphericalNoise/SphericalRandomField via
SHT power-law covariance, color.py:5 ColorNoise, temporal.py:8
TemporalNoise).

Each generator is a function of an explicit `torch.Generator` and the
state. Every draw of the ensemble modules goes through `normal`, one seam:
credit_tpu draws from jax.random keys, which no torch generator replays, so
the tests replace `normal` with credit_tpu's draws for the same key
sequence. The callers in the port pass CPU generators, so an ensemble's
draws do not depend on the device it runs on.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def normal(generator: torch.Generator, shape, dtype=torch.float32,
           device=None) -> torch.Tensor:
    """Standard normal draws of `shape` from `generator` (on the
    generator's device), moved to `device`."""
    out = torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=dtype)
    return out if device is None else out.to(device)


class GaussianNoise:
    """White Gaussian IC noise, std per channel or scalar."""

    def __init__(self, std: float = 0.01):
        self.std = std

    def __call__(self, generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        return x + self.std * normal(generator, x.shape, x.dtype, x.device)


class SphericalNoise:
    """Spatially correlated noise: random spherical field with power-law
    spectrum C_l ~ (l (l+1))^{-alpha/2}, synthesized by inverse SHT
    (reference: ensemble/spherical.py SphericalRandomField).

    As credit_tpu's: the amplitude is built for degrees 1..lmax but scales
    coefficient rows 0..lmax-1, so each degree takes the next one's power
    and the mean mode (l = 0) is drawn; the field is then scaled by its std
    over every channel at once. The port keeps both for parity (ROADMAP
    queue 3). The SHT's tables are built on the host and follow the state
    to its device."""

    def __init__(self, grid, std: float = 0.01, alpha: float = 2.0,
                 lmax: Optional[int] = None):
        from credit_torch.ops.sht import SHT

        self.sht = SHT(np.asarray(grid.lat), grid.nlon, lmax=lmax, grid="equiangular")
        self.std = std
        ls = np.arange(1, self.sht.lmax + 1, dtype=np.float64)
        power = (ls * (ls + 1.0)) ** (-alpha / 2.0)
        self.amp = torch.as_tensor(np.sqrt(power), dtype=torch.float32)[:, None]

    def field(self, generator: torch.Generator, shape_prefix=(), device=None) -> torch.Tensor:
        """(*shape_prefix, lat, lon) f32: the real then the imaginary
        normals of the coefficients, synthesized, scaled to unit std, then
        to `std`."""
        shape = (*shape_prefix, self.sht.lmax, self.sht.mmax)
        device = torch.device(device or "cpu")
        re = normal(generator, shape, device=device)
        im = normal(generator, shape, device=device)
        f = self.sht.to(device).spec2grid(torch.complex(re, im) * self.amp.to(device))
        f = f / (f.std(correction=0) + 1e-12)
        return self.std * f

    def __call__(self, generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        """x: (..., lat, lon, C): one correlated field per channel."""
        c = x.shape[-1]
        f = self.field(generator, (*x.shape[:-3], c), x.device)  # (..., C, lat, lon)
        return x + f.movedim(-3, -1).to(x.dtype)


class ColorNoise:
    """Channel-correlated (colored) noise: correlation across channels from a
    covariance factor, white in space (reference: ensemble/color.py)."""

    def __init__(self, std: float = 0.01, n_channels: Optional[int] = None,
                 chol: Optional[np.ndarray] = None):
        self.std = std
        self.chol = None if chol is None else torch.as_tensor(np.asarray(chol, np.float32))

    def __call__(self, generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        eps = normal(generator, x.shape, x.dtype, x.device)
        if self.chol is not None:
            eps = torch.einsum("...i,ij->...j", eps, self.chol.to(eps.device, eps.dtype))
        return x + self.std * eps


class TemporalNoise:
    """AR(1)-correlated noise across the time/frame axis
    (reference: ensemble/temporal.py): one innovation drawn per frame, in
    frame order."""

    def __init__(self, std: float = 0.01, rho: float = 0.8, time_axis: int = 1):
        self.std = std
        self.rho = rho
        self.time_axis = time_axis

    def __call__(self, generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        xs = x.movedim(self.time_axis, 0)
        innov = [normal(generator, xs.shape[1:], x.dtype, x.device) for _ in range(xs.shape[0])]
        z = torch.zeros_like(innov[0])
        zs = []
        for eps in innov:
            z = self.rho * z + math.sqrt(1 - self.rho**2) * eps
            zs.append(z)
        return x + self.std * torch.stack(zs).movedim(0, self.time_axis)


def hemispheric_rescale(noise: torch.Tensor, lat: np.ndarray, nh_scale: float = 1.0,
                        sh_scale: float = 1.0, tropics_scale: float = 1.0,
                        lat_axis: int = -3) -> torch.Tensor:
    """Scale noise differently by hemisphere/tropics
    (reference: ensemble/utils.py:45)."""
    w = np.full(lat.shape[0], tropics_scale, np.float32)
    w[lat > 20] = nh_scale
    w[lat < -20] = sh_scale
    shape = [1] * noise.dim()
    shape[lat_axis] = lat.shape[0]
    return noise * torch.as_tensor(w, device=noise.device).reshape(shape)

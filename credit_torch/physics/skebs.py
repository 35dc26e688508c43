"""SKEBS -- Stochastic Kinetic Energy Backscatter (Berner et al. 2009);
port of credit_tpu/physics/skebs.py.

The reference SKEBS (reference: credit/skebs.py:264 -- the AR(1) red-noise
spectral pattern initialize_pattern:553 / cycle_pattern:578, the
backscatter networks :37-242, the wind perturbation forward:596-760) keeps
hidden module state; here, as in credit_tpu, the state is an explicit
spectral coefficient array (complex64) that the caller carries, and the
noise comes from the caller's `torch.Generator`.

Pattern math (cycle_pattern parity):
  Gamma = sum_l l(l+1)(2l+1) l^{2p}
  b     = sqrt(4 pi R^2 alpha dE / (variance * Gamma))
  g_n   = b * l^p
  coef' = (1 - alpha) coef + g_n sqrt(alpha) * variance * eta
with eta's real and imaginary parts each a standard normal (credit_tpu's
normal(kr) + 1j normal(ki): two real draws, not torch's complex normal,
whose parts have variance 1/2), then a per-degree lowpass 'pattern
filter' with cosine annealing between (anneal_start, max_wavenum).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from credit_torch.ops.sht import SHT
from credit_torch.physics.constants import RAD_EARTH


def annealed_filter(lmax: int, max_wavenum: int, anneal_start: int) -> np.ndarray:
    """1 below anneal_start, cosine-annealed to 0 at max_wavenum, 0 above
    (reference skebs.py filter_init:515-531)."""
    f = np.ones(lmax, np.float32)
    ramp = np.arange(anneal_start, min(max_wavenum, lmax))
    if ramp.size:
        f[ramp] = 0.5 * (1 + np.cos(np.pi * (ramp - anneal_start) / max(ramp.size, 1)))
    f[min(max_wavenum, lmax):] = 0.0
    return f


@dataclasses.dataclass
class SKEBSParams:
    """Clippable scalars (reference clip ranges skebs.py:543-551)."""

    alpha: float = 0.05       # AR(1) 1-alpha memory; clip (eps, 1)
    variance: float = 1.0     # noise std; clip (eps, 10)
    p: float = -1.62          # spectral slope; clip (-10, -eps)
    dE: float = 1e-4          # backscattered energy fraction; clip (eps, 1)
    r: float = 0.5            # dissipation ratio; clip (eps, 1)

    def clipped(self) -> "SKEBSParams":
        eps = 1e-6
        return SKEBSParams(
            alpha=float(np.clip(self.alpha, eps, 1.0)),
            variance=float(np.clip(self.variance, eps, 10.0)),
            p=float(np.clip(self.p, -10.0, -eps)),
            dE=float(np.clip(self.dE, eps, 1.0)),
            r=float(np.clip(self.r, eps, 1.0)),
        )


class SKEBS:
    """Functional SKEBS: the state is the spectral pattern (B, lmax, mmax),
    complex64. The SHT and the filters move to the state's device at the
    first call."""

    def __init__(self, grid, params: Optional[SKEBSParams] = None,
                 lmax: Optional[int] = None, mmax: Optional[int] = None,
                 max_pattern_wavenum: int = 60, pattern_filter_anneal_start: int = 40,
                 max_backscatter_wavenum: int = 100, backscatter_filter_anneal_start: int = 90,
                 backscatter: float | Callable = 1e-5):
        self.sht = SHT(np.asarray(grid.lat), grid.nlon, lmax=lmax, mmax=mmax,
                       grid="equiangular")
        self.params = (params or SKEBSParams()).clipped()
        self.lrange = torch.arange(1, self.sht.lmax + 1, dtype=torch.float32)[:, None]
        self.pattern_filter = torch.from_numpy(annealed_filter(
            self.sht.lmax, max_pattern_wavenum, pattern_filter_anneal_start))[:, None]
        self.backscatter_filter = torch.from_numpy(annealed_filter(
            self.sht.lmax, max_backscatter_wavenum, backscatter_filter_anneal_start))[:, None]
        # a prescribed dissipation rate (m^3/s^3) or a callable
        # state -> rate field
        self.backscatter = backscatter

    def to(self, device) -> "SKEBS":
        """The SHT and the filters on `device`; returns self."""
        device = torch.device(device)
        self.sht.to(device)
        for name in ("lrange", "pattern_filter", "backscatter_filter"):
            t = getattr(self, name)
            if t.device != device:
                setattr(self, name, t.to(device))
        return self

    # ------------------------------------------------------------------
    def zero_state(self, batch: int, device="cpu") -> torch.Tensor:
        return torch.zeros((batch, self.sht.lmax, self.sht.mmax), dtype=torch.complex64,
                           device=device)

    def init_state(self, generator: Optional[torch.Generator], batch: int, iters: int = 5,
                   device="cpu") -> torch.Tensor:
        """Spin the AR(1) pattern up from zero (reference
        initialize_pattern), drawing from `generator` (on `device`)."""
        coef = self.zero_state(batch, device)
        for _ in range(iters):
            coef = self.cycle(coef, generator)
        return coef

    def noise(self, shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
        """eta: real and imaginary parts each N(0, 1), drawn in that order."""
        re = torch.randn(shape, generator=generator, device=device)
        im = torch.randn(shape, generator=generator, device=device)
        return torch.complex(re, im)

    def cycle(self, spec_coef: torch.Tensor, generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One AR(1) step. `noise` (complex, the state's shape) replays draws
        made elsewhere; without it they come from `generator`."""
        self.to(spec_coef.device)
        p = self.params
        lr = self.lrange
        gamma = torch.sum(lr * (lr + 1.0) * (2 * lr + 1.0) * lr ** (2.0 * p.p))
        b = torch.sqrt((4.0 * math.pi * RAD_EARTH**2) / (p.variance * gamma) * p.alpha * p.dE)
        g_n = b * lr ** p.p  # (lmax, 1)
        if noise is None:
            noise = self.noise(spec_coef.shape, generator, spec_coef.device)
        noise = p.variance * noise.to(spec_coef.device, torch.complex64)
        new = (1.0 - p.alpha) * spec_coef + g_n * math.sqrt(p.alpha) * noise
        return new * self.pattern_filter

    # ------------------------------------------------------------------
    def backscatter_rate(self, x_phys: Optional[torch.Tensor]) -> torch.Tensor:
        if callable(self.backscatter):
            return self.filter_rate(self.backscatter(x_phys))
        return torch.tensor(self.backscatter, dtype=torch.float32)

    def filter_rate(self, rate: torch.Tensor) -> torch.Tensor:
        """Spectrally low-pass a predicted backscatter-rate field, then ReLU
        (reference skebs.py:662-667 spectral_backscatter_filter + relu1)."""
        self.to(rate.device)
        spec = self.sht.grid2spec(rate) * self.backscatter_filter
        return torch.clamp(self.sht.spec2grid(spec), min=0.0)

    def perturb_winds(self, u: torch.Tensor, v: torch.Tensor, spec_coef: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      x_phys: Optional[torch.Tensor] = None, noise=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One SKEBS step: cycle the pattern, build the perturbation winds
        from its gradient, scale by sqrt(r * D / dE), add to (u, v).

        u, v: (B, ..., lat, lon) physical winds. Returns (u', v', new_coef).
        """
        new_coef = self.cycle(spec_coef, generator, noise)
        u_chi, v_chi = self.sht.grad_from_spec(new_coef)  # (B, lat, lon)
        # broadcast over any level/time axes between batch and lat
        for _ in range(u.dim() - u_chi.dim()):
            u_chi = u_chi[:, None]
            v_chi = v_chi[:, None]
        rate = self.backscatter_rate(x_phys).to(u.device)
        diss = torch.sqrt(self.params.r * rate / self.params.dE)
        return u + diss * u_chi, v + diss * v_chi, new_coef

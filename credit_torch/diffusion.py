"""Gaussian diffusion (DDPM training, DDIM sampling): port of
credit_tpu/diffusion.py.

The beta schedules are computed in float64 numpy and kept in f32, as in
credit_tpu. The backbone predicts eps, x0 or v from (condition, noisy
target, t / timesteps). Draws come from an explicit torch.Generator:
training takes t ~ U{0..T-1} per sample and eps ~ N(0, 1); DDIM sampling a
start y_T and one noise field per step (used only with ddim_eta > 0).
`loss_at` and `sample_from` take those draws as arguments instead, so a
caller can replay another source's draws.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch


def linear_beta_schedule(T: int) -> np.ndarray:
    scale = 1000.0 / T
    return np.linspace(scale * 1e-4, scale * 0.02, T)


def cosine_beta_schedule(T: int, s: float = 0.008) -> np.ndarray:
    steps = np.arange(T + 1, dtype=np.float64)
    ac = np.cos((steps / T + s) / (1 + s) * np.pi / 2) ** 2
    ac = ac / ac[0]
    betas = 1 - ac[1:] / ac[:-1]
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(T: int, start=-3.0, end=3.0, tau=1.0) -> np.ndarray:
    t = np.linspace(0, T, T + 1, dtype=np.float64) / T
    v_start = 1 / (1 + np.exp(-start / tau))
    v_end = 1 / (1 + np.exp(-end / tau))
    ac = (-1 / (1 + np.exp(-((t * (end - start) + start) / tau))) + v_end) / (v_end - v_start)
    ac = ac / ac[0]
    betas = 1 - ac[1:] / ac[:-1]
    return np.clip(betas, 1e-5, 0.999)


SCHEDULES = {"linear": linear_beta_schedule, "cosine": cosine_beta_schedule,
             "sigmoid": sigmoid_beta_schedule}
OBJECTIVES = ("pred_noise", "pred_x0", "pred_v")


class GaussianDiffusion:
    """The diffusion process around `backbone(cond, y_noisy, t_frac) ->
    prediction` (the shape of y; t_frac = t / timesteps, f32 (B,))."""

    def __init__(self, backbone: Callable, timesteps: int = 1000, sampling_timesteps: int = 50,
                 beta_schedule: str = "sigmoid", objective: str = "pred_v",
                 ddim_eta: float = 0.0):
        if objective not in OBJECTIVES:
            raise ValueError(f"objective {objective!r}: one of {OBJECTIVES}")
        self.backbone, self.timesteps = backbone, timesteps
        self.sampling_timesteps, self.objective, self.ddim_eta = (sampling_timesteps, objective,
                                                                  ddim_eta)
        betas = SCHEDULES[beta_schedule](timesteps)
        ac = np.cumprod(1.0 - betas)
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
        self.betas, self.alphas_cumprod = f32(betas), f32(ac)
        self.sqrt_ac, self.sqrt_1mac = f32(np.sqrt(ac)), f32(np.sqrt(1 - ac))

    def _coef(self, table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """table[t] as (B, 1, 1, 1, 1) on t's device."""
        return table.to(t.device)[t][:, None, None, None, None]

    def q_sample(self, y0, t, noise):
        """y_t = sqrt(ac_t) y0 + sqrt(1 - ac_t) eps."""
        return self._coef(self.sqrt_ac, t) * y0 + self._coef(self.sqrt_1mac, t) * noise

    def to_x0_eps(self, y_t, t, pred):
        """(x0, eps) from the backbone's prediction under the objective."""
        a, b = self._coef(self.sqrt_ac, t), self._coef(self.sqrt_1mac, t)
        if self.objective == "pred_noise":
            return (y_t - b * pred) / a, pred
        if self.objective == "pred_x0":
            return pred, (y_t - a * pred) / b
        return a * y_t - b * pred, b * y_t + a * pred  # v = a eps - b x0

    def target(self, y0, t, noise):
        if self.objective == "pred_noise":
            return noise
        if self.objective == "pred_x0":
            return y0
        return self._coef(self.sqrt_ac, t) * noise - self._coef(self.sqrt_1mac, t) * y0

    # ------------------------------------------------------------------
    def train_draws(self, y0: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(t (B,) int64, noise like y0) from `generator`, on y0's device."""
        t = torch.randint(0, self.timesteps, (y0.shape[0],), generator=generator,
                          device=y0.device)
        return t, torch.randn(y0.shape, generator=generator, device=y0.device, dtype=y0.dtype)

    def loss_at(self, cond, y0, t, noise, backbone: Optional[Callable] = None):
        """MSE of the objective at the given draws."""
        y_t = self.q_sample(y0, t, noise)
        pred = (backbone or self.backbone)(cond, y_t, t.float() / self.timesteps)
        return torch.mean((pred - self.target(y0, t, noise)) ** 2)

    def loss(self, cond, y0, generator: Optional[torch.Generator] = None,
             backbone: Optional[Callable] = None):
        """Training loss at a random t and noise from `generator`."""
        return self.loss_at(cond, y0, *self.train_draws(y0, generator), backbone)

    # ------------------------------------------------------------------
    def time_pairs(self) -> np.ndarray:
        """(S, 2) DDIM (t, t_next) pairs from T-1 down to -1."""
        times = np.linspace(-1, self.timesteps - 1, self.sampling_timesteps + 1)
        times = times.astype(int)[::-1]
        return np.stack([times[:-1], times[1:]], axis=1)

    def sample_draws(self, shape, generator: Optional[torch.Generator] = None, device=None):
        """(y_T, an iterator of each step's noise) from `generator`; a
        step's noise is drawn when the loop reaches it."""
        draw = lambda: torch.randn(shape, generator=generator, device=device)  # noqa: E731
        return draw(), (draw() for _ in range(self.sampling_timesteps))

    def sample_from(self, cond, y: torch.Tensor, noises: Iterable[torch.Tensor],
                    backbone: Optional[Callable] = None) -> torch.Tensor:
        """DDIM from the start y_T with the given per-step noise, a Python
        loop over the sampling steps."""
        fn = backbone or self.backbone
        ac = self.alphas_cumprod
        for (t, t_next), noise in zip(self.time_pairs(), noises):
            tb = torch.full((y.shape[0],), int(t), dtype=torch.int64, device=y.device)
            pred = fn(cond, y, tb.float() / self.timesteps)
            x0, eps = self.to_x0_eps(y, tb, pred)
            ac_next = ac[max(int(t_next), 0)] if t_next >= 0 else torch.tensor(1.0)
            ac_t = ac[int(t)]
            sigma = self.ddim_eta * torch.sqrt((1 - ac_t / ac_next) * (1 - ac_next) / (1 - ac_t))
            c = torch.sqrt(torch.clamp(1 - ac_next - sigma ** 2, min=0.0))
            y = (torch.sqrt(ac_next).item() * x0 + c.item() * eps
                 + sigma.item() * noise.to(y.device))
        return y

    def sample(self, cond, shape, generator: Optional[torch.Generator] = None,
               backbone: Optional[Callable] = None) -> torch.Tensor:
        """DDIM sampling with `sampling_timesteps` steps, draws from
        `generator`."""
        y, noises = self.sample_draws(shape, generator, cond.device)
        return self.sample_from(cond, y, noises, backbone)

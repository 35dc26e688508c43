"""Diffusion backbones: port of credit_tpu/models/diffusion_heads.py
(`crossformer-diffusion`, `unet-diffusion`).

forward(x, y_noisy=None, t_frac=None): the condition state and the noisy
target are concatenated along channels per frame, FiLM-modulated by an MLP
of a sinusoidal embedding of the diffusion time, and run through the
CrossFormer or the U-Net, whose first stage therefore takes
(C_in + C_out) * frames channels. Without y_noisy the target is zeros at
time 0 (a plain forward for shape checks).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from credit_torch import registry
from credit_torch.models.crossformer import CrossFormer
from credit_torch.models.layers import Dense
from credit_torch.models.unet import UNet


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t in [0, 1], shape (B,) -> (B, dim): sin and cos of 1000 t times
    frequencies 10000^(-i / (dim/2 - 1))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device, dtype=torch.float32)
                      / max(half - 1, 1))
    ang = t.float()[:, None] * 1000.0 * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TimeFiLM(nn.Module):
    """feat * (1 + scale) + shift, (scale, shift) = fc2(SiLU(fc1(emb(t)))),
    broadcast over every axis between the batch and the channels."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(128, 256, dtype=dtype, spectral=False)
        self.fc2 = Dense(256, 2 * channels, dtype=dtype, spectral=False)

    def forward(self, feat, t_frac):
        emb = sinusoidal_embedding(t_frac, 128).to(self.dtype)
        scale, shift = self.fc2(F.silu(self.fc1(emb))).chunk(2, dim=-1)
        shape = (feat.shape[0],) + (1,) * (feat.dim() - 2) + (feat.shape[-1],)
        return feat * (1 + scale.reshape(shape)) + shift.reshape(shape)


class _Denoiser:
    """The conditioning shared by both backbones (mixed in before them)."""

    def _init_film(self, dtype):
        self.time_film = TimeFiLM(self.stacked_input_channels(), dtype)

    def stacked_input_channels(self) -> int:
        return self.base_input_channels + self.base_output_channels

    def forward(self, x, y_noisy=None, t_frac=None):
        if y_noisy is None:
            y_noisy = x.new_zeros((*x.shape[:-1], self.base_output_channels))
            t_frac = x.new_zeros((x.shape[0],))
        x_in = self.time_film(torch.cat([x, y_noisy], dim=-1), t_frac)
        return super().forward(x_in)


@registry.register("model", "crossformer-diffusion")
class CrossFormerDiffusion(_Denoiser, CrossFormer):
    """CrossFormer denoiser."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._init_film(self.compute_dtype)


@registry.register("model", "unet-diffusion")
class UNetDiffusion(_Denoiser, UNet):
    """U-Net denoiser."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._init_film(self.compute_dtype)

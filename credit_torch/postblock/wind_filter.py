"""Jet-stream stripe-artifact wind filter (port of
credit_tpu/postblock/wind_filter.py).

Re-implements the reference's wind_artifact_filter (reference:
credit/postblock/wind_filter.py:10 _compute_blend_mask / :126 -- a
wind-speed threshold mask, anisotropic dilation (wider zonally), an
anisotropic Gaussian falloff into a 0-1 blend weight, then the winds
blended toward an anisotropically smoothed field). The separable smoothing
is plain PyTorch on one channel, as credit_tpu's is `lax.conv_general_dilated`
outside any Pallas kernel: one `F.conv2d` with a column kernel, one with a
row kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from credit_torch import registry
from credit_torch.data.channels import ChannelSchema
from credit_torch.postblock import BasePostblock, _VarView


def _gauss1d(sigma: float, half_mult: float = 2.0) -> np.ndarray:
    size = (int(2 * sigma * half_mult + 1)) | 1
    x = np.arange(size) - size // 2
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _sep_conv2d(f: torch.Tensor, k_lat: np.ndarray, k_lon: np.ndarray) -> torch.Tensor:
    """Separable 2-D smoothing of (..., H, W): edge-replicated in latitude,
    circular in longitude."""
    shape = f.shape
    x = f.reshape(-1, 1, shape[-2], shape[-1])  # (N, 1, H, W)
    ph, pw = len(k_lat) // 2, len(k_lon) // 2
    if ph:
        x = torch.cat([x[:, :, :1].expand(-1, -1, ph, -1), x,
                       x[:, :, -1:].expand(-1, -1, ph, -1)], dim=2)
    if pw:
        x = torch.cat([x[..., -pw:], x, x[..., :pw]], dim=3)
    kl = torch.from_numpy(np.asarray(k_lat, np.float32)).to(f.device, f.dtype)
    ko = torch.from_numpy(np.asarray(k_lon, np.float32)).to(f.device, f.dtype)
    x = F.conv2d(x, kl.reshape(1, 1, -1, 1))
    x = F.conv2d(x, ko.reshape(1, 1, 1, -1))
    return x.reshape(shape)


def compute_blend_mask(u: torch.Tensor, v: torch.Tensor, speed_threshold: float,
                       dilation_zonal: int, dilation_meridional: int,
                       falloff_sigma: float) -> torch.Tensor:
    """(..., H, W) winds at the mask level -> blend weight in [0, 1]."""
    speed = torch.sqrt(u**2 + v**2)
    mask = (speed > speed_threshold).to(u.dtype)
    # anisotropic dilation: a box convolution, clamped
    dil = _sep_conv2d(mask, np.ones(dilation_meridional, np.float32),
                      np.ones(dilation_zonal, np.float32))
    dil = torch.clamp(dil, 0.0, 1.0)
    # anisotropic Gaussian falloff (2x wider zonally, reference :52-60)
    blend = _sep_conv2d(dil, _gauss1d(falloff_sigma), _gauss1d(falloff_sigma * 2.0))
    return torch.clamp(blend, 0.0, 1.0)


@registry.register("postblock", "wind_artifact_filter")
class WindArtifactFilter(BasePostblock):
    def __init__(self, schema: ChannelSchema, U_var="U", V_var="V", mask_level: int = -1,
                 speed_threshold: float = 40.0, dilation_zonal: int = 9,
                 dilation_meridional: int = 3, falloff_sigma: float = 2.0,
                 smooth_sigma_zonal: float = 4.0, smooth_sigma_meridional: float = 0.75, **_):
        self.U = _VarView(schema, U_var)
        self.V = _VarView(schema, V_var)
        self.mask_level = mask_level
        self.speed_threshold = speed_threshold
        self.dz, self.dm = dilation_zonal, dilation_meridional
        self.falloff_sigma = falloff_sigma
        self.k_lat = _gauss1d(smooth_sigma_meridional)
        self.k_lon = _gauss1d(smooth_sigma_zonal)

    def __call__(self, y_pred, x):
        u = self.U.get(y_pred)  # (B, T, H, W, L) or (B, T, H, W)
        v = self.V.get(y_pred)
        has_lev = u.dim() == 5
        u_m = u[..., self.mask_level] if has_lev else u
        v_m = v[..., self.mask_level] if has_lev else v
        blend = compute_blend_mask(u_m, v_m, self.speed_threshold, self.dz, self.dm,
                                   self.falloff_sigma)
        if has_lev:
            # every level smoothed at once: levels moved before (H, W)
            blend = blend[..., None]
            u_s = _sep_conv2d(u.movedim(-1, -3), self.k_lat, self.k_lon).movedim(-3, -1)
            v_s = _sep_conv2d(v.movedim(-1, -3), self.k_lat, self.k_lon).movedim(-3, -1)
        else:
            u_s = _sep_conv2d(u, self.k_lat, self.k_lon)
            v_s = _sep_conv2d(v, self.k_lat, self.k_lon)
        y_pred = self.U.set(y_pred, u * (1 - blend) + u_s * blend)
        return self.V.set(y_pred, v * (1 - blend) + v_s * blend)

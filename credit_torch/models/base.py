"""Base model utilities (port of credit_tpu/models/base.py): the
(B, T, H, W, C) <-> flat-channel reshapes."""

from __future__ import annotations

import torch


def frames_to_channels(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, H, W, C*T), channel-major (index c*T + t)."""
    b, t, h, w, c = x.shape
    if t == 1:
        return x.reshape(b, h, w, c)
    return x.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * t)


def channels_to_frames(x: torch.Tensor, out_frames: int) -> torch.Tensor:
    """(B, H, W, C*T) -> (B, T, H, W, C), the inverse convention."""
    b, h, w, ct = x.shape
    c = ct // out_frames
    if out_frames == 1:
        return x.reshape(b, 1, h, w, c)
    return x.reshape(b, h, w, c, out_frames).permute(0, 4, 1, 2, 3)

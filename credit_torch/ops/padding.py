"""Spherical boundary padding for global lat-lon grids (port of
credit_tpu/ops/padding.py).

Layout: x is (..., lat, lon, channel) -- lat axis -3, lon axis -2.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

LAT_AXIS = -3
LON_AXIS = -2


def _norm_pads(p) -> Tuple[int, int]:
    if isinstance(p, int):
        return (p, p)
    a, b = p
    return int(a), int(b)


def earth_pad(x: torch.Tensor, pad_lat=(0, 0), pad_lon=(0, 0)) -> torch.Tensor:
    """Earth padding: across the poles with the 180-degree-rolled,
    lat-flipped pole rows; circular in longitude. Only the pole rows are
    rolled, never the whole field."""
    pn, ps = _norm_pads(pad_lat)
    pw, pe = _norm_pads(pad_lon)
    if pn > 0 or ps > 0:
        nlon = x.shape[LON_AXIS]
        keep = nlon - nlon // 2

        def roll180(rows):
            return torch.cat([rows[..., :, keep:, :], rows[..., :, :keep, :]], dim=LON_AXIS)

        parts = []
        if pn > 0:
            parts.append(torch.flip(roll180(x[..., :pn, :, :]), dims=(LAT_AXIS,)))
        parts.append(x)
        if ps > 0:
            parts.append(torch.flip(roll180(x[..., -ps:, :, :]), dims=(LAT_AXIS,)))
        x = torch.cat(parts, dim=LAT_AXIS)
    if pw > 0 or pe > 0:
        x = circular_pad_lon(x, (pw, pe))
    return x


def circular_pad_lon(x: torch.Tensor, pad_lon=(0, 0)) -> torch.Tensor:
    pw, pe = _norm_pads(pad_lon)
    parts = []
    if pw > 0:
        parts.append(x[..., :, -pw:, :])
    parts.append(x)
    if pe > 0:
        parts.append(x[..., :, :pe, :])
    return torch.cat(parts, dim=LON_AXIS) if len(parts) > 1 else x


def mirror_pad(x: torch.Tensor, pad_lat=(0, 0), pad_lon=(0, 0)) -> torch.Tensor:
    """Circular in longitude first, then reflect in latitude (edge row
    excluded, torch 'reflect')."""
    pw, pe = _norm_pads(pad_lon)
    pn, ps = _norm_pads(pad_lat)
    if pw > 0 or pe > 0:
        x = circular_pad_lon(x, (pw, pe))
    if pn > 0 or ps > 0:
        nlat = x.shape[LAT_AXIS]
        parts = []
        if pn > 0:
            parts.append(torch.flip(x[..., 1:pn + 1, :, :], dims=(LAT_AXIS,)))
        parts.append(x)
        if ps > 0:
            parts.append(torch.flip(x[..., nlat - ps - 1:nlat - 1, :, :], dims=(LAT_AXIS,)))
        x = torch.cat(parts, dim=LAT_AXIS)
    return x


def unpad(x: torch.Tensor, pad_lat=(0, 0), pad_lon=(0, 0)) -> torch.Tensor:
    """Crop padding added by earth_pad / mirror_pad."""
    pn, ps = _norm_pads(pad_lat)
    pw, pe = _norm_pads(pad_lon)
    nlat = x.shape[LAT_AXIS]
    nlon = x.shape[LON_AXIS]
    if pn > 0 or ps > 0:
        x = x[..., pn:nlat - ps, :, :]
    if pw > 0 or pe > 0:
        x = x[..., :, pw:nlon - pe, :]
    return x


class TensorPadding:
    """Config-driven pad/unpad pair."""

    def __init__(self, mode: str = "earth", pad_lat: Sequence[int] = (40, 40),
                 pad_lon: Sequence[int] = (40, 40), activate: bool = True, **kw):
        if mode not in ("earth", "mirror"):
            raise ValueError(f"padding mode must be earth|mirror, got {mode}")
        self.mode = mode
        self.pad_lat = _norm_pads(pad_lat)
        self.pad_lon = _norm_pads(pad_lon)

    def pad(self, x):
        fn = earth_pad if self.mode == "earth" else mirror_pad
        return fn(x, self.pad_lat, self.pad_lon)

    def unpad(self, x):
        return unpad(x, self.pad_lat, self.pad_lon)

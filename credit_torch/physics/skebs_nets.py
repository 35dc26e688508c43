"""Learned SKEBS backscatter-rate networks (port of
credit_tpu/physics/skebs_nets.py).

The reference's backscatter predictors (reference: credit/skebs.py:37
BackscatterFCNN, :64 BackscatterFCNNWide, :110 BackscatterCNN, :174
BackscatterUnet, :225 BackscatterFixedCol, :242 BackscatterPrescribed) as
channels-last `nn.Module`s: the input is the flat physical input state
(B, lat, lon, C_in), the output a non-negative per-level backscatter rate
(B, lat, lon, L). Parameter names and layouts are credit_tpu's flax ones
(`fc1.kernel` (in, out), `conv.kernel` HWIO, `backscatter_array`), so a
flax tree carries across by renaming. The dense layers are GEMMs and the
3x3 convs go through `ops/conv.py` as every model conv does (kernel 2, and
in training kernel 5). credit_tpu infers the input width at init; here it
is given (`in_channels`). Parameters start at zero: `init_` seeds them
(flax's defaults: lecun-normal kernels, zero biases, 2.5 columns).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from credit_torch import registry
from credit_torch.models.layers import Conv, Dense


def _earth_pad(x: torch.Tensor, p: int = 1) -> torch.Tensor:
    """Circular lon + 180-shifted replication lat (reference
    BackscatterCNN.pad, skebs.py:131): cross-pole columns wrap halfway
    around in longitude."""
    nlon = x.shape[-2]
    top = torch.roll(x[:, :1], nlon // 2, dims=-2)
    bot = torch.roll(x[:, -1:], nlon // 2, dims=-2)
    x = torch.cat([top, x, bot], dim=1)
    return torch.cat([x[:, :, -p:], x, x[:, :, :p]], dim=2)


def _dense(cin: int, cout: int) -> Dense:
    return Dense(cin, cout, spectral=False)


@registry.register("skebs_net", "fcnn")
class BackscatterFCNN(nn.Module):
    """Two-layer pointwise MLP (reference skebs.py:37)."""

    def __init__(self, levels: int, in_channels: int):
        super().__init__()
        self.levels = levels
        hidden = max(in_channels // 2, 1)
        self.fc1, self.fc2 = _dense(in_channels, hidden), _dense(hidden, levels)

    def forward(self, x):
        return F.relu(self.fc2(F.relu(self.fc1(x))))


@registry.register("skebs_net", "fcnn_wide")
class BackscatterFCNNWide(nn.Module):
    """Four-layer wide MLP, output clamped at 1000 (reference skebs.py:64)."""

    def __init__(self, levels: int, in_channels: int):
        super().__init__()
        self.levels = levels
        c = in_channels
        widths = (c, 2 * c, 4 * c, 2 * c, levels)
        for i in range(4):
            self.add_module(f"fc{i + 1}", _dense(widths[i], widths[i + 1]))

    def forward(self, x):
        for i in range(4):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return torch.clamp(x, max=1000.0)


@registry.register("skebs_net", "cnn")
class BackscatterCNN(nn.Module):
    """3x3 conv with earth padding + sigmoid (reference skebs.py:110)."""

    def __init__(self, levels: int, in_channels: int):
        super().__init__()
        self.levels = levels
        self.conv = Conv(in_channels, levels, 3)

    def forward(self, x):
        return torch.sigmoid(self.conv(_earth_pad(x, 1)))


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, channels last (even H and W)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest resize to twice the size: jax.image.resize's 'nearest' at an
    exact factor of 2 (output pixel i reads input i // 2)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


@registry.register("skebs_net", "unet")
class BackscatterUnet(nn.Module):
    """Small 2-level conv U-Net + relu output (credit_tpu's replacement of
    the reference's smp pretrained-encoder Unet, skebs.py:174)."""

    def __init__(self, levels: int, in_channels: int, width: int = 32):
        super().__init__()
        self.levels = levels
        w = width
        self.enc1 = Conv(in_channels, w, 3, padding=1)
        self.enc2 = Conv(w, 2 * w, 3, padding=1)
        self.mid = Conv(2 * w, 4 * w, 3, padding=1)
        self.dec2 = Conv(4 * w + 2 * w, 2 * w, 3, padding=1)
        self.dec1 = Conv(2 * w + w, w, 3, padding=1)
        self.head = Conv(w, levels, 1)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        ph, pw = (-h) % 4, (-w) % 4
        if ph or pw:  # edge padding at the bottom and right
            x = torch.cat([x, x[:, -1:].expand(-1, ph, -1, -1)], dim=1)
            x = torch.cat([x, x[:, :, -1:].expand(-1, -1, pw, -1)], dim=2)
        c1 = F.relu(self.enc1(x))
        c2 = F.relu(self.enc2(_max_pool2(c1)))
        b = F.relu(self.mid(_max_pool2(c2)))
        c3 = F.relu(self.dec2(torch.cat([_upsample2(b), c2], dim=-1)))
        c4 = F.relu(self.dec1(torch.cat([_upsample2(c3), c1], dim=-1)))
        return F.relu(self.head(c4))[:, :h, :w]


class _Column(nn.Module):
    """A per-level column rate broadcast over the grid."""

    def __init__(self, levels: int, fill: float = 2.5):
        super().__init__()
        self.levels = levels
        self.backscatter_array = nn.Parameter(torch.zeros(levels))
        self._fill = fill

    def forward(self, x):
        shape = (1,) * (x.dim() - 1) + (self.levels,)
        return self.backscatter_array.reshape(shape).expand(*x.shape[:-1], self.levels)


@registry.register("skebs_net", "fixed_column")
class BackscatterFixedCol(_Column):
    """Trainable uniform-in-space column rate, init 2.5 (reference
    skebs.py:225)."""

    def __init__(self, levels: int, in_channels: Optional[int] = None):
        super().__init__(levels)


@registry.register("skebs_net", "prescribed")
class BackscatterPrescribed(_Column):
    """A fixed column profile (reference skebs.py:242): trainable like the
    others; init `profile`, or 2.5."""

    def __init__(self, levels: int, in_channels: Optional[int] = None,
                 profile: Sequence[float] = None):
        super().__init__(levels)
        self.profile = None if profile is None else [float(v) for v in profile]


def init_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seed `net`'s parameters in place, flax's defaults: each kernel
    lecun-normal (a normal of std sqrt(1 / fan_in) / 0.8796..., truncated
    at two of its std, fan_in every axis but the last), biases zero, a
    column's `backscatter_array` 2.5 or its profile. Draws come from
    `generator` on its own device, in parameter order."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf == "kernel":
                std = math.sqrt(1.0 / math.prod(p.shape[:-1])) / 0.87962566103423978
                k = torch.empty(p.shape, device=generator.device)
                torch.nn.init.trunc_normal_(k, 0.0, std, -2 * std, 2 * std, generator=generator)
                p.copy_(k)
            elif leaf == "bias":
                p.zero_()
            elif leaf == "backscatter_array":
                mod = net.get_submodule(name.rpartition(".")[0]) if "." in name else net
                prof = getattr(mod, "profile", None)
                p.copy_(torch.as_tensor(prof, dtype=p.dtype) if prof is not None
                        else torch.full_like(p, mod._fill))
    return net


def build_backscatter_net(conf: dict, levels: int, in_channels: int) -> nn.Module:
    """conf: {'type': fcnn|fcnn_wide|cnn|unet|fixed_column|prescribed, ...}
    (reference dispatch skebs.py:361-396); parameters zero until `init_`
    or a checkpoint fills them."""
    conf = dict(conf)
    kind = conf.pop("type", "fcnn")
    cls = registry.get("skebs_net", kind)
    return cls(levels=levels, in_channels=in_channels, **conf)

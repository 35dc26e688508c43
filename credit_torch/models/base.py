"""Base model utilities (port of credit_tpu/models/base.py): the
(B, T, H, W, C) <-> flat-channel reshapes, and construction from a config's
model section."""

from __future__ import annotations

import inspect

import torch
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class BaseModel(nn.Module):
    """A ported model whose constructor arguments mirror the reference
    config's model keys. `ROUTING_KEYS` are the reference's TPU routing
    switches: on CUDA the port always takes its kernels, so they are
    accepted and ignored."""

    ROUTING_KEYS: tuple = ()

    def _check_routing(self, routing: dict) -> None:
        unknown = set(routing) - set(self.ROUTING_KEYS)
        if unknown:
            raise TypeError(f"{type(self).__name__}: unexpected arguments {sorted(unknown)}")

    @classmethod
    def from_config(cls, conf: dict, sn_state: bool = False) -> "BaseModel":
        """Build from a gen2 config dict; model-section keys that are not
        constructor arguments are ignored, as in the reference."""
        names = set(cls.ROUTING_KEYS)
        for klass in cls.__mro__:  # a subclass's own arguments and its bases'
            if issubclass(klass, BaseModel) and "__init__" in vars(klass):
                names |= set(inspect.signature(klass.__init__).parameters)
        mconf = {k: v for k, v in conf["model"].items() if k in names and k != "type"}
        return cls(**mconf, sn_state=sn_state)


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

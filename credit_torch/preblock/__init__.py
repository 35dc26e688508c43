"""Preblock pipeline: composable input processors applied before the model
(port of credit_tpu/preblock/__init__.py; reference:
credit/preblock/__init__.py:134 build_preblocks, :271 apply_preblocks).

Blocks are callables x -> x on the flat channels-last input tensor
(B, T_hist, lat, lon, C_in), addressed through static ChannelSchema slices,
built per phase: 'ic_only' blocks run once on the normalized initial
state, 'per_step' blocks on the input of every rollout step (the train
and eval steps, `trainers/trainer.py`). Constant tensors are made on the
CPU and follow the input's device at the first call.

Every key of the reference's registry is here: era5_normalizer,
log_transform, sqrt_transform, fill_values, clamp, regrid,
bridgescaler_transform, hybrid_level_interp and semilagrangian_advection.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from credit_torch import registry
from credit_torch.data.channels import ChannelSchema
from credit_torch.ops.regrid import _Tables, make_regridder
from credit_torch.postblock import _VarView


class BasePreblock:
    phase = "per_step"

    def __call__(self, x):
        raise NotImplementedError


@registry.register("preblock", "era5_normalizer")
class NormalizePreblock(BasePreblock):
    """z-score normalize the flat input tensor (reference preblock/norm.py)."""

    def __init__(self, schema=None, normalizer=None, **_):
        self.norm = normalizer

    def __call__(self, x):
        return self.norm.normalize_input(x)


@registry.register("preblock", "log_transform")
class LogTransform(BasePreblock):
    """log1p on selected variables (inverse pairs with postblock 'exp')."""

    def __init__(self, schema: ChannelSchema, variables: Sequence[str],
                 epsilon: float = 0.0, **_):
        self.views = [_VarView(schema, v, target=False) for v in variables]
        self.eps = epsilon

    def __call__(self, x):
        for view in self.views:
            x = view.set(x, torch.log1p(torch.clamp(view.get(x) + self.eps, min=0.0)))
        return x


@registry.register("preblock", "sqrt_transform")
class SqrtTransform(BasePreblock):
    def __init__(self, schema: ChannelSchema, variables: Sequence[str], **_):
        self.views = [_VarView(schema, v, target=False) for v in variables]

    def __call__(self, x):
        for view in self.views:
            x = view.set(x, torch.sqrt(torch.clamp(view.get(x), min=0.0)))
        return x


@registry.register("preblock", "fill_values")
class FillValues(BasePreblock):
    """Replace NaN/inf (reference preblock fill_values)."""

    def __init__(self, schema=None, fill_value: float = 0.0, **_):
        self.fill = fill_value

    def __call__(self, x):
        return torch.where(torch.isfinite(x), x, torch.full_like(x, self.fill))


@registry.register("preblock", "clamp")
class Clamp(BasePreblock):
    """IC clamp (the trainer-side clamp in trainer_gen2)."""

    def __init__(self, schema=None, min: float = -1e4, max: float = 1e4, **_):
        self.lo, self.hi = min, max

    def __call__(self, x):
        return torch.clamp(x, self.lo, self.hi)


def build_preblocks(conf: dict, schema: ChannelSchema, normalizer=None,
                    phase: str = "per_step", grid=None) -> List[Callable]:
    """Build from conf['preblocks'] = [{type:..., phase:..., args...}]."""
    blocks = []
    for entry in (conf.get("preblocks") or []):
        entry = dict(entry)
        btype = entry.pop("type")
        if entry.pop("phase", "per_step") != phase:
            continue
        cls = registry.get("preblock", btype)
        kwargs = dict(schema=schema, normalizer=normalizer, **entry)
        if btype in ("regrid", "semilagrangian_advection"):
            kwargs["grid"] = grid
        blocks.append(cls(**kwargs))
    return blocks


def apply_preblocks(blocks: Sequence[Callable], x):
    for b in blocks:
        x = b(x)
    return x


@registry.register("preblock", "regrid")
class RegridPreblock(BasePreblock):
    """Horizontal regrid of the whole input tensor onto the model grid
    (reference: credit/preblock/regrid.py Regridder — xesmf weights there,
    precomputed index/weight gathers here via credit_torch/ops/regrid.py,
    whose tables follow the input's device)."""

    def __init__(self, schema=None, src_lat=None, src_lon=None,
                 dst_lat=None, dst_lon=None, method: str = "bilinear",
                 grid=None, **_):
        if dst_lat is None and grid is not None:
            dst_lat, dst_lon = grid.lat, grid.lon
        self.rg = make_regridder(method, np.asarray(src_lat),
                                 np.asarray(src_lon), np.asarray(dst_lat),
                                 np.asarray(dst_lon))

    def __call__(self, x):
        b, t, h, w, c = x.shape
        flat = x.permute(0, 1, 4, 2, 3).reshape(b * t * c, h, w)
        out = self.rg(flat)
        h2, w2 = out.shape[-2:]
        return out.reshape(b, t, c, h2, w2).permute(0, 1, 3, 4, 2)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp row by row: x (R, N) at the knots xp (R, n), increasing
    with possible ties, and values fp (R, n). The interval is the last knot
    <= x; one of zero width gives its left value; outside the table the end
    values."""
    n = xp.shape[-1]
    i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    x0, x1 = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    f0, f1 = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    dx = x1 - x0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx), dx))
                    * (f1 - f0))
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


@registry.register("preblock", "bridgescaler_transform")
class BridgeScalerTransform(BasePreblock):
    """Distribution-aware per-channel scaling (reference:
    credit/preblock/scaler.py BridgeScalerTransform on bridgescaler's
    DQuantile/DStandard/DMinMax tensors). kind='quantile' maps each channel
    through its stored quantiles to normal scores (monotone piecewise-linear
    CDF + probit), 'standard' z-scores, 'minmax' rescales to [0, 1].
    Stats come from a scaler.npz (`quantiles` (C, n_q); `mean`, `std`;
    `min`, `max`)."""

    def __init__(self, schema=None, path: str = None, kind: str = "quantile",
                 inverse: bool = False, **_):
        data = np.load(path)
        self.kind = kind
        self.inverse = inverse

        def f32(name):
            return torch.from_numpy(np.asarray(data[name], np.float32))

        if kind == "quantile":
            self.quantiles = f32("quantiles")  # (C, n_q)
            nq = self.quantiles.shape[1]
            # the uniform scores clipped away from 0/1 so probit stays finite
            self.probs = torch.from_numpy(
                np.linspace(1.0 / (nq + 1), nq / (nq + 1.0), nq).astype(np.float32))
        elif kind == "standard":
            self.mean, self.std = f32("mean"), f32("std")
        elif kind == "minmax":
            self.lo, self.hi = f32("min"), f32("max")
        else:
            raise ValueError(f"unknown scaler kind {kind!r}")

    def __call__(self, x):
        x = torch.as_tensor(x)
        if self.kind == "standard":
            self.mean, self.std = self.mean.to(x.device), self.std.to(x.device)
            return (x * self.std + self.mean) if self.inverse else (x - self.mean) / self.std
        if self.kind == "minmax":
            self.lo, self.hi = self.lo.to(x.device), self.hi.to(x.device)
            rng = self.hi - self.lo
            return (x * rng + self.lo) if self.inverse else (x - self.lo) / rng
        self.quantiles = q = self.quantiles.to(x.device)
        self.probs = p = self.probs.to(x.device)
        c = x.shape[-1]
        rows = x.reshape(-1, c).T.contiguous()  # (C, N)
        probs = p.expand(c, -1).contiguous()
        if self.inverse:
            u = torch.clamp(torch.special.ndtr(rows), p[0], p[-1])
            out = _interp(u, probs, q)
        else:
            out = torch.special.ndtri(_interp(rows, q, probs))
        return out.T.reshape(x.shape)


@registry.register("preblock", "hybrid_level_interp")
class HybridLevelInterp(BasePreblock, _Tables):
    """Interpolate 3-D input variables from source hybrid levels onto the
    model's hybrid levels, at full levels (interface means) of each
    (reference: credit/preblock/hybrid_interp.py HybridLevelInterpPre on the
    interp engine)."""

    _tables = ("ak_in", "bk_in", "ak_out", "bk_out")

    def __init__(self, schema: ChannelSchema, variables: Sequence[str], ak_in=None, bk_in=None,
                 ak_out=None, bk_out=None, sp_var: str = "SP", **_):
        self.views = [_VarView(schema, v, target=False) for v in variables]
        self.sp = _VarView(schema, sp_var, target=False)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
        self.ak_in, self.bk_in = f32(ak_in), f32(bk_in)
        self.ak_out, self.bk_out = f32(ak_out), f32(bk_out)

    def __call__(self, x):
        from credit_torch.physics.interp import create_pressure_grid, interp_hybrid_to_hybrid

        self._on(x.device)
        sp = self.sp.get(x)
        _, p_in = create_pressure_grid(sp, self.ak_in, self.bk_in)
        _, p_out = create_pressure_grid(sp, self.ak_out, self.bk_out)
        for view in self.views:
            x = view.set(x, interp_hybrid_to_hybrid(view.get(x), p_in, p_out))
        return x


@registry.register("preblock", "semilagrangian_advection")
class AdvectionPreblock(BasePreblock):
    """Advect input tracers one step with the input winds BEFORE the model
    (reference: credit/preblock/advect.py SemiLagrangianAdvectionPre)."""

    def __init__(self, schema: ChannelSchema, grid=None, a_half=None, b_half=None,
                 tracer_vars: Sequence[str] = ("Q",), U_var="U", V_var="V", sp_var="SP",
                 timestep_seconds: float = 21600.0, n_iterations: int = 2, **_):
        from credit_torch.physics.advection import SemiLagrangianAdvection

        self.engine = SemiLagrangianAdvection(grid, a_half, b_half, timestep_seconds,
                                              n_iterations)
        self.tracers = [_VarView(schema, v, target=False) for v in tracer_vars]
        self.U = _VarView(schema, U_var, target=False)
        self.V = _VarView(schema, V_var, target=False)
        self.sp = _VarView(schema, sp_var, target=False)

    def __call__(self, x):
        b, t = x.shape[:2]
        hw = x.shape[2:4]
        u = self.U.get(x).reshape(b * t, *hw, -1)
        v = self.V.get(x).reshape(b * t, *hw, -1)
        sp = self.sp.get(x).reshape(b * t, *hw)
        for tv in self.tracers:
            f = tv.get(x)
            adv = self.engine.advect([f.reshape(b * t, *hw, -1)], u, v, sp)[0]
            x = tv.set(x, adv.reshape(f.shape))
        return x

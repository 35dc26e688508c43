"""Postblock pipeline: composable per-step output processors (port of
credit_tpu/postblock/__init__.py; reference: credit/postblock/__init__.py:147
build_postblocks, :207 apply_postblocks; conservation fixers in
credit/postblock/conservation.py:84-420).

Blocks are callables (y_pred, x) -> y_pred on the flat channels-last tensors
  y_pred: (B, T_out, lat, lon, C_target)   x: (B, T_hist, lat, lon, C_in)
addressed through static ChannelSchema slices, each in the space its place
in the pipeline gives it (Denorm first / Renorm last runs the fixers on
physical predictions, as the reference's inverse-transform -> fixers ->
rescale order). `_VarView.set` returns a new tensor in the old one's dtype,
as `.at[].set` does. Constant tensors are made on the CPU and follow the
prediction's device at the first call.

Ported: denorm, renorm, exp, square, wet_mask_samudra, tracer_fixer and the
global mass, water and energy fixers. The other keys of the reference's
registry are registered here too and raise `NotImplementedError` naming
their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from credit_torch import registry
from credit_torch.data.channels import ChannelSchema
from credit_torch.physics.constants import CP_DRY, CP_VAPOR, GRAVITY, LH_WATER, RHO_WATER
from credit_torch.physics.core import HybridSigmaPhysics, PressureLevelPhysics


# ---------------------------------------------------------------------------
# schema addressing helpers

def _chan_indices(schema: ChannelSchema, name: str, target: bool = True):
    entries = schema.target_entries if target else schema.input_entries
    exact = [e.index for e in entries if e.name == name]
    if exact:
        return exact[0], None
    levs = sorted(
        (int(e.name.rpartition("_L")[2]), e.index)
        for e in entries
        if e.name.startswith(f"{name}_L") and e.name.rpartition("_L")[2].isdigit()
    )
    if not levs:
        raise KeyError(f"variable '{name}' not in {'target' if target else 'input'} schema")
    idxs = [i for _, i in levs]
    start, stop = idxs[0], idxs[-1] + 1
    if idxs != list(range(start, stop)):
        raise ValueError(f"{name}: non-contiguous levels")
    return start, stop


class _VarView:
    """Static channel addressing for one variable in the flat tensors."""

    def __init__(self, schema: ChannelSchema, name: str, target: bool = True):
        self.start, self.stop = _chan_indices(schema, name, target)
        self.is3d = self.stop is not None

    def get(self, flat):
        if self.is3d:
            return flat[..., self.start:self.stop]  # (..., L)
        return flat[..., self.start]  # (...)

    def set(self, flat, value):
        out = flat.clone()
        if self.is3d:
            out[..., self.start:self.stop] = value
        else:
            out[..., self.start] = value
        return out


class BasePostblock:
    def __call__(self, y_pred, x):
        raise NotImplementedError


# ---------------------------------------------------------------------------


@registry.register("postblock", "denorm")
class Denorm(BasePostblock):
    def __init__(self, normalizer, **_):
        self.norm = normalizer

    def __call__(self, y_pred, x):
        return self.norm.denormalize_target(y_pred)


@registry.register("postblock", "renorm")
class Renorm(BasePostblock):
    def __init__(self, normalizer, **_):
        self.norm = normalizer

    def __call__(self, y_pred, x):
        return self.norm.normalize_target(y_pred)


@registry.register("postblock", "exp")
class ExpTransform(BasePostblock):
    """expm1 on selected target variables -- inverse of the log_transform
    preblock (reference: postblock exp/square transforms)."""

    def __init__(self, schema: ChannelSchema, variables, **_):
        self.views = [_VarView(schema, v) for v in variables]

    def __call__(self, y_pred, x):
        for view in self.views:
            y_pred = view.set(y_pred, torch.expm1(view.get(y_pred)))
        return y_pred


@registry.register("postblock", "square")
class SquareTransform(BasePostblock):
    """Square selected target variables -- inverse of sqrt_transform."""

    def __init__(self, schema: ChannelSchema, variables, **_):
        self.views = [_VarView(schema, v) for v in variables]

    def __call__(self, y_pred, x):
        for view in self.views:
            y_pred = view.set(y_pred, view.get(y_pred) ** 2)
        return y_pred


@registry.register("postblock", "wet_mask_samudra")
class WetMaskSamudra(BasePostblock):
    """Zero ocean-model predictions over land (reference: postblock
    wet_mask_samudra for the OM4/Samudra ocean emulator): multiply every
    target channel by the wet mask (1 = ocean)."""

    def __init__(self, schema: ChannelSchema, wet_mask, **_):
        if isinstance(wet_mask, str):
            raise NotImplementedError(
                "wet_mask_samudra from a netCDF path is not ported yet: its reader "
                "(utils/ncio) comes with the data pipeline (ROADMAP queue 1, item 12); "
                "pass the mask as an array")
        self.mask = torch.as_tensor(np.asarray(wet_mask, np.float32))  # (lat, lon) or (lat, lon, L)

    def __call__(self, y_pred, x):
        self.mask = self.mask.to(y_pred.device)
        m = self.mask
        if m.dim() == 2:
            m = m[..., None]
        return y_pred * m


@registry.register("postblock", "tracer_fixer")
class TracerFixer(BasePostblock):
    """Clamp tracers to [lo, hi] (reference: conservation.py:84 TracerFixer)."""

    def __init__(self, schema: ChannelSchema, tracer_vars: Sequence[str],
                 tracer_thres, tracer_thres_max=None, **_):
        n = len(tracer_vars)
        self.views = [_VarView(schema, v) for v in tracer_vars]
        self.lo = tracer_thres if isinstance(tracer_thres, (list, tuple)) else [tracer_thres] * n
        if tracer_thres_max is None:
            self.hi = [None] * n
        else:
            self.hi = (tracer_thres_max if isinstance(tracer_thres_max, (list, tuple))
                       else [tracer_thres_max] * n)

    def __call__(self, y_pred, x):
        for view, lo, hi in zip(self.views, self.lo, self.hi):
            y_pred = view.set(y_pred, torch.clamp(view.get(y_pred), lo, hi))
        return y_pred


class _FixerBase(BasePostblock):
    """Shared: schema views for prognostic state in y_pred and in x."""

    def __init__(self, schema: ChannelSchema, grid, ak=None, bk=None,
                 pressure_levels=None, midpoint: bool = True):
        self.schema = schema
        if ak is not None:
            self.core = HybridSigmaPhysics(grid, ak, bk, midpoint=midpoint)
            self.sigma = True
        elif pressure_levels is not None:
            self.core = PressureLevelPhysics(grid, pressure_levels, midpoint=midpoint)
            self.sigma = False
        else:
            raise ValueError("need ak/bk (sigma) or pressure_levels")

    def _tview(self, name):
        return _VarView(self.schema, name, target=True)

    def _iview(self, name):
        return _VarView(self.schema, name, target=False)


@registry.register("postblock", "global_mass_fixer")
class GlobalMassFixer(_FixerBase):
    """Rescale surface pressure so predicted global dry-air mass matches the
    input state (reference: conservation.py:117 GlobalMassFixer; sigma grid).
    """

    def __init__(self, schema, grid, q_var="Q", sp_var="SP", **kw):
        super().__init__(schema, grid, **kw)
        if not self.sigma:
            raise ValueError("mass fixer needs the hybrid-sigma grid")
        self.qt, self.spt = self._tview(q_var), self._tview(sp_var)
        self.qi, self.spi = self._iview(q_var), self._iview(sp_var)

    def __call__(self, y_pred, x):
        core = self.core.to(y_pred.device)
        q_pred = self.qt.get(y_pred)          # (B, T, H, W, L)
        sp_pred = self.spt.get(y_pred)        # (B, T, H, W)
        q_in = self.qi.get(x)[:, -1:]         # last input frame
        sp_in = self.spi.get(x)[:, -1:]

        mass_t0 = core.total_dry_air_mass(q_in, sp_in)  # (B, 1)

        da = torch.diff(core.ak)
        db = torch.diff(core.bk)
        if core.midpoint:
            q_mid = q_pred
        else:
            q_mid = 0.5 * (q_pred[..., :-1] + q_pred[..., 1:])
        p_dry_a = torch.sum(da * (1.0 - q_mid), dim=-1)
        p_dry_b = torch.sum(db * (1.0 - q_mid), dim=-1)
        mass_a = torch.sum(p_dry_a * core.area, dim=(-2, -1)) / GRAVITY
        mass_b = torch.sum(p_dry_b * sp_pred * core.area, dim=(-2, -1)) / GRAVITY
        ratio = (mass_t0 - mass_a) / mass_b    # (B, T)
        return self.spt.set(y_pred, sp_pred * ratio[..., None, None])


@registry.register("postblock", "global_water_fixer")
class GlobalWaterFixer(_FixerBase):
    """Rescale precipitation to close the global water budget
    (reference: conservation.py:179 GlobalWaterFixer)."""

    def __init__(self, schema, grid, q_var="Q", sp_var="SP",
                 precip_var="total_precipitation", evapor_var="evaporation",
                 lead_time_periods=6, **kw):
        super().__init__(schema, grid, **kw)
        self.qt, self.spt = self._tview(q_var), self._tview(sp_var)
        self.pt, self.et = self._tview(precip_var), self._tview(evapor_var)
        self.qi, self.spi = self._iview(q_var), self._iview(sp_var)
        self.n_seconds = float(int(lead_time_periods) * 3600)

    def __call__(self, y_pred, x):
        core = self.core.to(y_pred.device)
        q_pred = self.qt.get(y_pred)
        sp_pred = self.spt.get(y_pred)
        precip = self.pt.get(y_pred)
        evapor = self.et.get(y_pred)
        q_in = self.qi.get(x)[:, -1:]
        sp_in = self.spi.get(x)[:, -1:]

        precip_flux = precip * RHO_WATER / self.n_seconds
        evapor_flux = evapor * RHO_WATER / self.n_seconds
        if self.sigma:
            twc_in = core.total_column_water(q_in, sp_in)
            twc_pred = core.total_column_water(q_pred, sp_pred)
        else:
            twc_in = core.total_column_water(q_in)
            twc_pred = core.total_column_water(q_pred)
        dtwc_dt = (twc_pred - twc_in) / self.n_seconds
        twc_sum = core.weighted_sum(dtwc_dt)
        e_sum = core.weighted_sum(evapor_flux)
        p_sum = core.weighted_sum(precip_flux)
        residual = -twc_sum - e_sum - p_sum
        # dry-globe guard: zero global precip means nothing to rescale --
        # ratio 1 instead of 0/0 (early-training batches can be all-dry)
        safe = torch.abs(p_sum) > 1e-12
        one = torch.ones_like(p_sum)
        ratio = torch.where(safe, (p_sum + residual) / torch.where(safe, p_sum, one), one)
        return self.pt.set(y_pred, precip * ratio[..., None, None])


@registry.register("postblock", "global_energy_fixer")
class GlobalEnergyFixer(_FixerBase):
    """Correct temperature so the column total-energy tendency matches net
    TOA + surface fluxes (reference: conservation.py:239
    GlobalEnergyFixerUpDown, up/down flux decomposition, or net fluxes)."""

    def __init__(self, schema, grid, surface_geopotential,
                 T_var="T", q_var="Q", U_var="U", V_var="V", sp_var="SP",
                 toa_down_solar_input_var="tsi",
                 toa_up_solar_var="top_net_solar_radiation",
                 toa_up_olr_var="top_net_thermal_radiation",
                 surf_down_solar_var=None, surf_up_solar_var=None,
                 surf_down_lw_var=None, surf_up_lw_var=None,
                 surf_net_solar_var=None, surf_net_lw_var=None,
                 surf_sh_var="surface_sensible_heat_flux",
                 surf_lh_var="surface_latent_heat_flux",
                 lead_time_periods=6, **kw):
        super().__init__(schema, grid, **kw)
        if not self.sigma:
            raise ValueError("energy fixer needs the hybrid-sigma grid")
        self.Tt, self.qt = self._tview(T_var), self._tview(q_var)
        self.Ut, self.Vt = self._tview(U_var), self._tview(V_var)
        self.spt = self._tview(sp_var)
        self.qi, self.spi = self._iview(q_var), self._iview(sp_var)
        self.Ti = self._iview(T_var)
        self.Ui, self.Vi = self._iview(U_var), self._iview(V_var)
        self.solin_i = self._iview(toa_down_solar_input_var)
        self.toa_us = self._tview(toa_up_solar_var)
        self.toa_olr = self._tview(toa_up_olr_var)
        # up/down decomposition or net fluxes
        self.updown = surf_down_solar_var is not None
        if self.updown:
            self.s_ds = self._tview(surf_down_solar_var)
            self.s_us = self._tview(surf_up_solar_var)
            self.s_dl = self._tview(surf_down_lw_var)
            self.s_ul = self._tview(surf_up_lw_var)
        else:
            self.s_ns = self._tview(surf_net_solar_var)
            self.s_nl = self._tview(surf_net_lw_var)
        self.s_sh = self._tview(surf_sh_var)
        self.s_lh = self._tview(surf_lh_var)
        self.gph_surf = torch.as_tensor(np.asarray(surface_geopotential, np.float32))
        self.n_seconds = float(int(lead_time_periods) * 3600)

    def __call__(self, y_pred, x):
        core = self.core.to(y_pred.device)
        self.gph_surf = gph = self.gph_surf.to(y_pred.device)
        T1, q1 = self.Tt.get(y_pred), self.qt.get(y_pred)
        U1, V1 = self.Ut.get(y_pred), self.Vt.get(y_pred)
        sp1 = self.spt.get(y_pred)
        T0, q0 = self.Ti.get(x)[:, -1:], self.qi.get(x)[:, -1:]
        U0, V0 = self.Ui.get(x)[:, -1:], self.Vi.get(x)[:, -1:]
        sp0 = self.spi.get(x)[:, -1:]

        cp0 = (1 - q0) * CP_DRY + q0 * CP_VAPOR
        cp1 = (1 - q1) * CP_DRY + q1 * CP_VAPOR
        eqgk0 = LH_WATER * q0 + gph[..., None] + 0.5 * (U0**2 + V0**2)
        eqgk1 = LH_WATER * q1 + gph[..., None] + 0.5 * (U1**2 + V1**2)

        solin = self.solin_i.get(x)[:, -1:]
        r_t = solin - self.toa_us.get(y_pred) - self.toa_olr.get(y_pred)
        r_t_sum = core.weighted_sum(r_t)
        if self.updown:
            f_s = (self.s_ds.get(y_pred) - self.s_us.get(y_pred)
                   + self.s_dl.get(y_pred) - self.s_ul.get(y_pred)
                   + self.s_sh.get(y_pred) + self.s_lh.get(y_pred))
        else:
            f_s = (self.s_ns.get(y_pred) + self.s_nl.get(y_pred)
                   + self.s_sh.get(y_pred) + self.s_lh.get(y_pred))
        f_s_sum = core.weighted_sum(f_s)

        e0 = cp0 * T0 + eqgk0
        e1 = cp1 * T1 + eqgk1
        te0 = core.integral(e0, sp0) / GRAVITY
        te1 = core.integral(e1, sp1) / GRAVITY
        g0 = core.weighted_sum(te0)
        g1 = core.weighted_sum(te1)

        ratio = (self.n_seconds * (r_t_sum - f_s_sum) + g0) / g1
        e1c = e1 * ratio[..., None, None, None]
        T_new = (e1c - eqgk1) / cp1
        return self.Tt.set(y_pred, T_new)


def _unported(key: str, item: str):
    """A registry entry for a reference postblock the port does not have yet."""

    class Unported(BasePostblock):
        def __init__(self, *_, **__):
            raise NotImplementedError(f"postblock '{key}' is not ported yet ({item})")

    Unported.__name__ = Unported.__qualname__ = f"Unported_{key}"
    registry.register("postblock", key)(Unported)


for _key, _item in [
        ("skebs", "ROADMAP queue 1, item 7: postblock/stochastic.py, physics/skebs"),
        ("semilagrangian_advection",
         "ROADMAP queue 1, item 7: postblock/stochastic.py, physics/advection"),
        ("wind_artifact_filter", "ROADMAP queue 1, item 7: postblock/wind_filter.py"),
        ("hybrid_level_interp", "ROADMAP queue 1, item 7: physics/interp.py"),
        ("pressure_interp_diagnostic", "ROADMAP queue 1, item 7: physics/interp.py"),
        ("mslp_diagnostic", "ROADMAP queue 1, item 7: physics/interp.py"),
        ("geopotential_diagnostic", "ROADMAP queue 1, item 7: physics/interp.py")]:
    _unported(_key, _item)


# ---------------------------------------------------------------------------


def build_postblocks(conf: dict, schema: ChannelSchema, grid,
                     normalizer=None, extra_ctx: Optional[dict] = None) -> List[Callable]:
    """Build the per-step postblock pipeline from post_conf
    (reference: credit/postblock/__init__.py:147). Keys with
    {'activate': True} are built in the reference's fixed order:
    tracer -> mass -> water -> energy."""
    post_conf = (conf.get("model", {}) or {}).get("post_conf") or conf.get("post_conf") or {}
    if not post_conf.get("activate"):
        return []
    # gen1 PostBlock op order: tracer -> SKEBS -> mass -> water -> energy
    # (reference postblock/gen1.py:37), then diagnostics and filters;
    # wet_mask first so land stays zero through everything downstream
    # (reference: gen2 postblock registry 'wet_mask_samudra')
    order = ["wet_mask_samudra",
             "tracer_fixer", "skebs", "global_mass_fixer", "global_water_fixer",
             "global_energy_fixer", "semilagrangian_advection",
             "wind_artifact_filter", "mslp_diagnostic", "geopotential_diagnostic"]
    blocks: List[Callable] = []
    need_phys = any(post_conf.get(k, {}).get("activate") for k in order)
    if need_phys and normalizer is not None:
        blocks.append(Denorm(normalizer))
    ctx = dict(extra_ctx or {})
    for key in order:
        sub = post_conf.get(key) or {}
        if not sub.get("activate"):
            continue
        cls = registry.get("postblock", key)
        kwargs = {k: v for k, v in sub.items() if k != "activate"}
        blocks.append(cls(schema=schema, grid=grid, **{**ctx, **kwargs}))
    if need_phys and normalizer is not None:
        blocks.append(Renorm(normalizer))
    return blocks


def apply_postblocks(blocks: Sequence[Callable], y_pred, x):
    for b in blocks:
        y_pred = b(y_pred, x)
    return y_pred

"""Stateful postblocks: SKEBS perturbation and semi-Lagrangian advection
(port of credit_tpu/postblock/stochastic.py).

The reference runs SKEBS inside the model's gen1 PostBlock with hidden
module state (reference: credit/postblock/gen1.py:37, the ordered op list
with SKEBS second; credit/skebs.py carries spec_coef across forward calls).
Here, as in credit_tpu, they are stateful postblocks: the state is explicit
and the caller carries it, with a `torch.Generator` for the noise.

Protocol:
  block.init_state(batch_size, device) -> state
  block(y_pred, x, state, generator[, net_params]) -> (y_pred, new_state)
Stateless postblocks keep the plain (y_pred, x) -> y_pred signature.

A trainable block (SKEBS with a `backscatter_net`) owns its net as an
`nn.Module` (`block.net`); its parameters join the train state under
`_postblocks.<i>.`, i the block's index in the pipeline (the `Denorm`
counts, at 0), as credit_tpu keys `params['_postblocks']`. `net_params`
(name -> tensor) runs the net on other tensors (an EMA's, a checkpoint's)
through `torch.func.functional_call`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from credit_torch import registry
from credit_torch.data.channels import ChannelSchema
from credit_torch.postblock import BasePostblock, _VarView


class StatefulPostblock(BasePostblock):
    is_stateful = True

    def init_state(self, batch_size: int, device="cpu"):
        raise NotImplementedError

    def __call__(self, y_pred, x, state, generator):
        raise NotImplementedError


@registry.register("postblock", "skebs")
class SKEBSPostblock(StatefulPostblock):
    """Perturb the predicted winds with the SKEBS backscatter pattern
    (reference: skebs.py:596 forward -- the perturbation applied to the U/V
    channels of y_pred in physical space).

    With `backscatter_net` configured (e.g. {'type': 'cnn'}), the
    dissipation rate is predicted from the last input frame by a trainable
    net whose parameters the optimizer updates with the model (reference:
    the learned FCNN/CNN/Unet backscatter, skebs.py:37-242,553-760)."""

    def __init__(self, schema: ChannelSchema, grid, U_var="U", V_var="V",
                 backscatter_net=None, dissipation_scaling: float = 1.0,
                 write_rollout_debug_files: bool = False, save_loc: str = ".",
                 iteration_stop: int = 0, **skebs_kwargs):
        from credit_torch.physics.skebs import SKEBS, SKEBSParams

        params = SKEBSParams(**{k: skebs_kwargs.pop(k) for k in ("alpha", "variance", "p", "dE",
                                                                "r") if k in skebs_kwargs})
        for k in ("activate", "write_train_debug_files", "write_train_every"):
            skebs_kwargs.pop(k, None)
        # rollout debug writers (reference: skebs.py:426-440): the stream-
        # function pattern and the perturbation winds of every step
        self.write_rollout_debug_files = bool(write_rollout_debug_files)
        self.debug_save_loc = os.path.join(save_loc, "debug_skebs")
        self.iteration_stop = int(iteration_stop)
        self.skebs = SKEBS(grid, params, **skebs_kwargs)
        self.U = _VarView(schema, U_var)
        self.V = _VarView(schema, V_var)
        self.scaling = dissipation_scaling
        self.net = None
        if backscatter_net:
            from credit_torch.physics.skebs_nets import build_backscatter_net

            n_lev = max(getattr(schema, "n_levels", 1), 1)
            self.net = build_backscatter_net(backscatter_net, n_lev, schema.n_input)
        self.is_trainable = self.net is not None

    def init_state(self, batch_size: int, device="cpu"):
        """(the AR(1) pattern spun up from a generator seeded 0, so every
        call starts from the same pattern, as credit_tpu's PRNGKey(0);
        the iteration counter, a 0-d int32 tensor that drives
        iteration_stop, reference skebs.py:443)."""
        gen = torch.Generator(device=device).manual_seed(0)
        coef = self.skebs.init_state(gen, batch_size, device=device)
        return coef, torch.zeros((), dtype=torch.int32, device=device)

    def init_params(self, generator: torch.Generator, device="cpu"):
        """Seed the net on `device` and return it; None without a net.
        credit_tpu's init reads a sample for flax's shape inference; here
        the input width is the schema's (`in_channels`)."""
        if self.net is None:
            return None
        from credit_torch.physics.skebs_nets import init_

        return init_(self.net.to(device), generator)

    def _rate(self, x, net_params: Optional[Dict[str, torch.Tensor]]):
        if self.net is None:
            return self.skebs.backscatter_rate(None).to(x.device), False
        frame = x[:, -1]
        if net_params is None:
            rate = self.net(frame)
        else:
            rate = torch.func.functional_call(self.net, net_params, (frame,))  # (B, H, W, L)
        rate = self.scaling * rate
        # the spectral low-pass per level: the SHT acts on (lat, lon) last
        rate = self.skebs.filter_rate(rate.movedim(-1, 1)).movedim(1, -1)
        return rate, True

    def __call__(self, y_pred, x, state, generator=None, net_params=None):
        coef, it = state
        u = self.U.get(y_pred)  # (B, T, H, W, L) or (B, T, H, W)
        v = self.V.get(y_pred)
        has_lev = u.dim() == 5
        # the SKEBS pattern is (B, lat, lon); broadcast over T (and levels)
        new_coef = self.skebs.cycle(coef, generator)
        u_chi, v_chi = self.skebs.sht.grad_from_spec(new_coef)
        pert_u = u_chi[:, None, :, :]
        pert_v = v_chi[:, None, :, :]
        if has_lev:
            pert_u = pert_u[..., None]
            pert_v = pert_v[..., None]
        rate, learned = self._rate(x, net_params)
        if learned:
            rate = rate[:, None]  # (B, 1, H, W, L)
            if not has_lev:
                rate = rate.mean(-1)
            # ReLU'd rates reach 0 exactly, where sqrt's gradient is
            # infinite: clamped, the gradient is 0 below the threshold
            rate = torch.clamp(rate, min=1e-10)
        diss = torch.sqrt(self.skebs.params.r * rate / self.skebs.params.dE)
        if self.iteration_stop:
            # early shutoff (reference skebs.py:443): the perturbation times
            # 0 once the counter reaches iteration_stop, on the device
            diss = diss * (it < self.iteration_stop).to(diss.dtype)
        y_pred = self.U.set(y_pred, u + diss * pert_u)
        y_pred = self.V.set(y_pred, v + diss * pert_v)
        return y_pred, (new_coef, it + 1)

    def dump_debug(self, step: int, state):
        """Write the step's SKEBS pattern fields to
        `debug_skebs/skebs_NNNN.nc` (reference: skebs.py
        write_rollout_debug_files); returns the path. Reads the state on
        the host: the rollout engine calls it between steps."""
        from credit_torch.utils.ncio import Dataset

        os.makedirs(self.debug_save_loc, exist_ok=True)
        coef = state[0]
        with torch.no_grad():
            u_chi, v_chi = self.skebs.sht.grad_from_spec(coef)
            psi = self.skebs.sht.spec2grid(coef)
        path = os.path.join(self.debug_save_loc, f"skebs_{step:04d}.nc")
        Dataset({name: (("batch", "lat", "lon"), np.asarray(t.float().cpu().numpy()))
                 for name, t in (("psi_pattern", psi), ("pert_u", u_chi),
                                 ("pert_v", v_chi))}).to_netcdf(path)
        return path


@registry.register("postblock", "semilagrangian_advection")
class AdvectionPostblock(BasePostblock):
    """Advect tracers one step with the predicted winds (reference:
    credit/postblock/advect.py:426). Stateless: the winds and SP come from
    y_pred."""

    def __init__(self, schema: ChannelSchema, grid, a_half, b_half,
                 tracer_vars: Sequence[str] = ("Q",), U_var="U", V_var="V", sp_var="SP",
                 timestep_seconds: float = 21600.0, n_iterations: int = 2, **_):
        from credit_torch.physics.advection import SemiLagrangianAdvection

        self.engine = SemiLagrangianAdvection(grid, a_half, b_half, timestep_seconds,
                                              n_iterations)
        self.tracers = [_VarView(schema, v) for v in tracer_vars]
        self.U = _VarView(schema, U_var)
        self.V = _VarView(schema, V_var)
        self.sp = _VarView(schema, sp_var)

    def __call__(self, y_pred, x):
        b, t = y_pred.shape[:2]
        hw = y_pred.shape[2:4]
        u = self.U.get(y_pred).reshape(b * t, *hw, -1)
        v = self.V.get(y_pred).reshape(b * t, *hw, -1)
        sp = self.sp.get(y_pred).reshape(b * t, *hw)
        fields = [tv.get(y_pred) for tv in self.tracers]
        flat = [f.reshape(b * t, *hw, -1) for f in fields]
        out = self.engine.advect(flat, u, v, sp)
        for tv, orig, adv in zip(self.tracers, fields, out):
            y_pred = tv.set(y_pred, adv.reshape(orig.shape))
        return y_pred


def apply_postblocks_stateful(blocks, y_pred, x, states: dict,
                              generator: Optional[torch.Generator] = None,
                              params: Optional[dict] = None):
    """Apply a mixed stateless / stateful pipeline; returns (y_pred, states).
    The stateful blocks draw from `generator` in pipeline order; `params`
    maps a trainable block's index, str(i), to its net's tensors (name ->
    tensor); a block it leaves out runs its own net."""
    new_states = dict(states)
    for i, b in enumerate(blocks):
        if getattr(b, "is_stateful", False):
            if getattr(b, "is_trainable", False):
                y_pred, new_states[i] = b(y_pred, x, states[i], generator,
                                          net_params=(params or {}).get(str(i)))
            else:
                y_pred, new_states[i] = b(y_pred, x, states[i], generator)
        else:
            y_pred = b(y_pred, x)
    return y_pred, new_states


def init_postblock_states(blocks, batch_size: int, device="cpu") -> dict:
    return {i: b.init_state(batch_size, device) for i, b in enumerate(blocks)
            if getattr(b, "is_stateful", False)}


def postblock_nets(blocks) -> torch.nn.ModuleDict:
    """The trainable blocks' nets, keyed by str(index)."""
    return torch.nn.ModuleDict({str(i): b.net for i, b in enumerate(blocks)
                                if getattr(b, "is_trainable", False)})


def init_postblock_params(blocks, generator: torch.Generator,
                          device="cpu") -> torch.nn.ModuleDict:
    """Seed every trainable block's net from `generator` (in pipeline order)
    on `device`; returns them keyed by str(index), the train
    state's `_postblocks` (reference: the backscatter nets are parameters
    of the wrapped model)."""
    for b in blocks:
        if getattr(b, "is_trainable", False):
            b.init_params(generator, device)
    return postblock_nets(blocks)


def split_postblock_params(tensors: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """`_postblocks.<i>.<name>` entries of a flat tensor dict as {i: {name:
    tensor}}; other entries are left out."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in tensors.items():
        if k.startswith("_postblocks."):
            i, _, name = k[len("_postblocks."):].partition(".")
            out.setdefault(i, {})[name] = v
    return out

"""The `era5-diffusion` trainer: port of credit_tpu/trainers/diffusion.py.

`Trainer.fit` with its two steps swapped. Training: per step, the batch
normalized, t and eps drawn from the state's generator, the noised first
target frame regressed under the objective (pred_v by default) conditioned
on the input state, with spectral norm's u/v left as they are (the
reference applies the model outside train mode); a non-finite loss zeroes
the gradients and keeps the parameters through `torch.where` (no host
read), then the EMA. Validation: a DDIM sample of the first target frame
from the EMA weights, scored by MSE. The config's `diffusion` section sets
timesteps (1000), sampling_timesteps (20), beta_schedule (sigmoid),
objective (pred_v) and ddim_eta (0). Under trainer.parallelism both steps
run as the main trainer's do: under explicit_halo(mesh) (the CrossFormer
denoiser lat-sharded), ZeRO-3 over dp (the parameters held as chunks and
gathered block by block), the gradients and the loss reduced over the
group, the EMA in the sharded optimizer's chunks (swapped in for the
parameters' for validation), the validation loss averaged over the group.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from credit_torch import registry
from credit_torch.diffusion import GaussianDiffusion
from credit_torch.models.layers import freeze_sn_updates
from credit_torch.parallel import context as par_ctx
from credit_torch.trainers.trainer import (Trainer, TrainState, _ema_decay, _global_loss,
                                           _Parallel, _prepare, global_norm)


@registry.register("trainer", "era5-diffusion")
class DiffusionTrainer(Trainer):
    """Conditional denoising training with DDIM validation; the model is a
    diffusion backbone (`crossformer-diffusion`, `unet-diffusion`)."""

    def __init__(self, conf: dict, model, loss_fn, valid_loss_fn, schema, dataset,
                 valid_dataset=None, save_loc: Optional[str] = None, normalizer=None,
                 device="cuda"):
        super().__init__(conf, model, loss_fn, valid_loss_fn, schema, dataset, valid_dataset,
                         save_loc, normalizer, device)
        d = conf.get("diffusion", {}) or {}
        self.gd = GaussianDiffusion(
            lambda cond, y_noisy, t_frac: model(cond, y_noisy=y_noisy, t_frac=t_frac),
            timesteps=int(d.get("timesteps", 1000)),
            sampling_timesteps=int(d.get("sampling_timesteps", 20)),
            beta_schedule=d.get("beta_schedule", "sigmoid"),
            objective=d.get("objective", "pred_v"), ddim_eta=float(d.get("ddim_eta", 0.0)))
        self._eval_step = self.diffusion_eval_step
        self._par = None  # the mesh's gradient divisors, made at the first step

    def _train_step_for(self, flen: int):
        """Single-step denoising whatever the scheduled rollout length."""
        return self.diffusion_train_step

    def diffusion_train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """One optimizer step of the denoising loss; (state, metrics) with
        'loss', 'grad_norm' and 'finite' as 0-d tensors on the device."""
        mdl = state.model
        mdl.train()
        params = state.named_parameters()
        for p in params.values():
            p.grad = None
        batch = _prepare(batch, self.device, self.normalizer, self.schema)
        with freeze_sn_updates(True), par_ctx.explicit_halo(self.mesh):
            loss = self.gd.loss(batch["x"], batch["y"][:, :1], state.noise)
        loss.backward()
        names = list(state.opt_state["mu"])
        plist = [params[k] for k in names]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in plist]
        loss = loss.detach()
        if self.mesh is not None:
            if self._par is None:
                self._par = _Parallel(self.mesh, mdl, names, self.optimizer)
            grads = self._par.reduce(grads)
            loss = _global_loss(loss, self._par)
        finite = torch.isfinite(loss)
        with torch.no_grad():
            grads = [torch.where(finite, g, 0.0) for g in grads]
            updates, opt_state = self.optimizer.update(grads, state.opt_state, plist)
            if updates is not None:
                new = torch._foreach_add(plist, updates)
                for p, n in zip(plist, new):
                    p.copy_(torch.where(finite, n, p))
            ema = state.ema_params
            if ema is not None:
                d = _ema_decay(self.ema_decay if self.use_ema else 0.0, state.step)
                evals = [ema[k] for k in names]
                view = getattr(self.optimizer, "view", None)
                cur = plist if view is None else [view(k, p) for k, p in zip(names, plist)]
                torch._foreach_mul_(evals, d)
                torch._foreach_add_(evals, cur, alpha=1.0 - d)
            gnorm = global_norm(grads) if self._par is None else self._par.norm(grads)
        for p in plist:
            p.grad = None
        new_state = TrainState(state.step + 1, mdl, opt_state, ema, state.noise, state.nets)
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "finite": finite.float()}

    def diffusion_eval_step(self, state: TrainState, batch,
                            generator: Optional[torch.Generator] = None):
        """{'loss': MSE of a DDIM sample of the first target frame}, drawn
        from `generator` on the EMA weights where the state keeps them."""
        mdl = state.model
        mdl.eval()
        tensors = None
        if state.ema_params is not None:
            ema = state.ema_params
            if self.mesh is not None:
                ema = dict(zip(ema, self.optimizer.unshard(ema)))
            tensors = {**ema, **dict(mdl.named_buffers())}

        def backbone(cond, y_noisy, t_frac):
            kw = {"y_noisy": y_noisy, "t_frac": t_frac}
            if tensors is None:
                return mdl(cond, **kw)
            return torch.func.functional_call(mdl, tensors, (cond,), kw)

        with torch.no_grad(), par_ctx.explicit_halo(self.mesh):
            batch = _prepare(batch, self.device, self.normalizer, self.schema)
            y0 = batch["y"][:, :1]
            sample = self.gd.sample(batch["x"], y0.shape, generator, backbone)
            out = {"loss": torch.mean((sample - y0) ** 2)}
        if self.mesh is None:
            return out
        from credit_torch.parallel.sharding import all_reduce_mean

        return all_reduce_mean(out)

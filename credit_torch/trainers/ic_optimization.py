"""Initial-condition optimization: port of
credit_tpu/trainers/ic_optimization.py (reference:
credit/trainers/ic_optimization.py -- optimize the INPUT state against a
forecast-trajectory loss with the model frozen; a 4D-Var-like analysis
step): Adam on x0 through the rollout, the model's parameters frozen.

The gradient reaches x0 through the kernels' backward: kernel 4 for each
FF (which computes the frozen parameters' gradients too), kernel 2 on the
flipped kernel for each conv's input gradient (kernel 5 is skipped: no
conv weight needs a gradient) and autograd of attention's plain version.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from credit_torch import registry, resolve_device
from credit_torch.data.channels import ChannelSchema


@registry.register("trainer", "ic-opt")
def optimize_initial_condition(
        model, schema: ChannelSchema, x0, targets, forcing=None, n_steps: int = 1,
        history_len: int = 1, iterations: int = 50, learning_rate: float = 1e-2,
        loss_fn: Optional[Callable] = None, background_weight: float = 0.0, device="cuda"):
    """Return (x0_optimized, losses): `iterations` Adam steps (optax.adam's
    defaults, which torch's Adam shares: betas 0.9 / 0.999, eps 1e-8) on x0
    of the mean over n_steps of loss_fn(target, prediction) (the MSE by
    default) along the model's rollout, plus background_weight times the
    mean squared pull toward the first guess (Tikhonov). losses[i] is the
    loss at the i-th iterate, before its update. The model (on `device`,
    CUDA unless the caller asks for the CPU) runs in eval mode with its
    parameters frozen; both are restored on return.

    x0: (B, T_hist, H, W, C_in); targets: (B, S, H, W, C_t); forcing:
    (B, S, H, W, n_dyn) or None."""
    dev = resolve_device(device)
    if loss_fn is None:
        loss_fn = lambda t, p: torch.mean((p - t) ** 2)  # noqa: E731
    x_guess = torch.as_tensor(x0).to(dev)
    targets = torch.as_tensor(targets).to(dev)
    forcing = None if forcing is None else torch.as_tensor(forcing).to(dev)

    def trajectory_loss(x):
        total = 0.0
        xc = x
        for s in range(n_steps):
            y_pred = model(xc)
            total = total + loss_fn(targets[:, s][:, None], y_pred)
            if s + 1 < n_steps:
                f = None if forcing is None else forcing[:, s + 1][:, None]
                frame = schema.update_x(xc[:, -1:], y_pred[:, -1:], f)
                xc = torch.cat([xc[:, 1:], frame], dim=1) if history_len > 1 else frame
        total = total / n_steps
        if background_weight > 0:
            total = total + background_weight * torch.mean((x - x_guess) ** 2)
        return total

    trainable = [p for p in model.parameters() if p.requires_grad]
    training = model.training
    x = x_guess.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=learning_rate)
    losses = []
    try:
        model.eval()
        for p in trainable:
            p.requires_grad_(False)
        for _ in range(iterations):
            opt.zero_grad(set_to_none=True)
            loss = trajectory_loss(x)
            loss.backward()
            opt.step()
            losses.append(loss.item())
    finally:
        for p in trainable:
            p.requires_grad_(True)
        model.train(training)
    return x.detach(), losses

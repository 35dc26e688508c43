"""Precipitation-type classification post-processor: port of
credit_tpu/ptype.py (reference: credit/credit_ptype.py:19 -- a pretrained
keras/mlguess evidential MLP over (T, Td) height profiles producing
rain/snow/ice-pellet/freezing-rain probabilities with aleatoric+epistemic
uncertainty, plus dewpoint derivation via metpy).

The classifier is an evidential MLP (`nn.Linear`s with ReLU and a softplus
Dirichlet-evidence head); its weights read and write credit_tpu's npz
layout (`fc0/kernel` as (in, out), `fc0/bias`, ..., `evidence/*`, and the
feature `mean`/`std`), so weights carry across both ways. Dewpoint comes
from an explicit Magnus inversion (no metpy), and the whole grid
classifies in one call. Output variable names match the reference's
save_vars (ML_rain, ML_crain, ML_rain_ale/epi, ... credit_ptype.py:21-39).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from credit_torch import resolve_device

PTYPES = ("rain", "snow", "icep", "frzr")


def dewpoint_from_q(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Dewpoint (K) from specific humidity (kg/kg) and pressure (Pa) via the
    Magnus formula inverted on vapor pressure (reference uses
    metpy.dewpoint_from_specific_humidity, credit_ptype.py:50)."""
    w = q / torch.clamp(1.0 - q, min=1e-6)  # mixing ratio
    e = p * w / (0.622 + w)  # vapor pressure (Pa)
    ln = torch.log(torch.clamp(e, min=1e-3) / 611.2)
    td_c = 243.5 * ln / (17.67 - ln)
    return td_c + 273.15


class PTypeNet(nn.Module):
    """Evidential MLP over the concatenated (T, Td) column profile (the
    mlguess CategoricalDNN evidential architecture analogue): hidden layers
    fc0.. with ReLU, then softplus evidence >= 0 (Dirichlet alpha =
    evidence + 1)."""

    def __init__(self, n_features: int, hidden: Sequence[int] = (64, 64),
                 n_classes: int = len(PTYPES)):
        super().__init__()
        widths = [n_features, *hidden]
        self.hidden = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.evidence = nn.Linear(widths[-1], n_classes)

    def forward(self, x):
        for fc in self.hidden:
            x = F.relu(fc(x))
        return F.softplus(self.evidence(x))


def evidential_outputs(evidence: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Dirichlet evidence -> probabilities + uncertainties (mlguess
    evidential_cat_loss convention: alpha = e+1, S = sum alpha,
    p = alpha/S, epistemic u = K/S, aleatoric = p(1-p)*S/(S+1) var)."""
    alpha = evidence + 1.0
    s = alpha.sum(-1, keepdim=True)
    p = alpha / s
    k = evidence.shape[-1]
    return {"prob": p, "u": k / s[..., 0], "ale": p * (1.0 - p) * s / (s + 1.0),
            "epi": p * (1.0 - p) / (s + 1.0)}


class PTypeClassifier:
    """Grid-wide precip-type classification (reference: credit_ptype.py:167
    grid_predictions + :254 ptype_classification) on one device, CUDA
    unless the caller asks for the CPU. Weights come from `weights_path`
    (credit_tpu's npz layout; the hidden widths are the file's) or from
    `init`."""

    def __init__(self, weights_path: Optional[str] = None, hidden: Sequence[int] = (64, 64),
                 mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.hidden = tuple(hidden)
        self.net: Optional[PTypeNet] = None
        self.mean, self.std = mean, std
        if weights_path:
            data = np.load(weights_path, allow_pickle=False)
            layers = {}
            for key in data.files:
                if key in ("mean", "std"):
                    setattr(self, key, data[key])
                    continue
                name, leaf = key.split("/")
                layers.setdefault(name, {})[leaf] = data[key]
            n_hidden = sum(1 for k in layers if k.startswith("fc"))
            fcs = [layers[f"fc{i}"] for i in range(n_hidden)]
            self.hidden = tuple(int(fc["bias"].shape[0]) for fc in fcs)
            net = PTypeNet(int(fcs[0]["kernel"].shape[0]) if fcs
                           else int(layers["evidence"]["kernel"].shape[0]), self.hidden)
            with torch.no_grad():
                for lin, prm in zip([*net.hidden, net.evidence], [*fcs, layers["evidence"]]):
                    lin.weight.copy_(torch.from_numpy(np.asarray(prm["kernel"], np.float32).T))
                    lin.bias.copy_(torch.from_numpy(np.asarray(prm["bias"], np.float32)))
            self.net = net.to(self.device).eval()

    def init(self, generator: torch.Generator, n_features: int) -> PTypeNet:
        """Seeded weights (flax Dense's: LeCun-normal kernels truncated at
        two deviations, zero biases), drawn from the CPU `generator`."""
        net = PTypeNet(n_features, self.hidden)
        with torch.no_grad():
            for lin in [*net.hidden, net.evidence]:
                std = (1.0 / lin.in_features) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                nn.init.zeros_(lin.bias)
        self.net = net.to(self.device).eval()
        return self.net

    def save(self, path: str):
        """credit_tpu's npz layout: <layer>/kernel (in, out), <layer>/bias,
        and mean / std when set."""
        flat = {}
        names = [f"fc{i}" for i in range(len(self.net.hidden))] + ["evidence"]
        for name, lin in zip(names, [*self.net.hidden, self.net.evidence]):
            flat[f"{name}/kernel"] = lin.weight.detach().cpu().numpy().T
            flat[f"{name}/bias"] = lin.bias.detach().cpu().numpy()
        if self.mean is not None:
            flat["mean"], flat["std"] = self.mean, self.std
        np.savez(path, **flat)

    @torch.no_grad()
    def __call__(self, t_profile, td_profile) -> Dict[str, np.ndarray]:
        """t/td_profile: (..., L) column profiles (K). Returns the
        reference's ML_* fields on the leading grid shape, as numpy."""
        if self.net is None:
            raise RuntimeError("classifier has no weights: call init() or "
                               "load from weights_path")
        feats = torch.cat([torch.as_tensor(t_profile), torch.as_tensor(td_profile)],
                          dim=-1).to(self.device, torch.float32)
        if self.mean is not None:
            feats = ((feats - torch.as_tensor(np.asarray(self.mean), device=self.device))
                     / torch.as_tensor(np.asarray(self.std), device=self.device))
        grid_shape = feats.shape[:-1]
        out = evidential_outputs(self.net(feats.reshape(-1, feats.shape[-1])))
        prob = out["prob"].reshape(*grid_shape, len(PTYPES))
        ale = out["ale"].reshape(*grid_shape, len(PTYPES))
        epi = out["epi"].reshape(*grid_shape, len(PTYPES))
        winner = torch.argmax(prob, dim=-1)
        fields = {"ML_u": out["u"].reshape(grid_shape)}
        for i, name in enumerate(PTYPES):
            fields[f"ML_{name}"] = prob[..., i]
            fields[f"ML_c{name}"] = (winner == i).float()
            fields[f"ML_{name}_ale"] = ale[..., i]
            fields[f"ML_{name}_epi"] = epi[..., i]
        return {k: v.cpu().numpy() for k, v in fields.items()}

    def classify_state(self, y_pred, schema, grid, t_var: str = "T", q_var: str = "Q",
                       sp_var: str = "SP") -> Dict[str, np.ndarray]:
        """Classify directly from a flat prediction tensor: the column
        pressures from SP and the grid's hybrid coefficients (else its
        levels), dewpoint from Q, then the evidential net (reference:
        dewpoint_temp + extract_variable_levels, credit_ptype.py:41,105)."""
        from credit_torch.physics.interp import create_pressure_grid
        from credit_torch.postblock import _VarView

        y = torch.as_tensor(y_pred).to(self.device, torch.float32)
        t = _VarView(schema, t_var).get(y)
        q = _VarView(schema, q_var).get(y)
        sp = _VarView(schema, sp_var).get(y)
        if grid.ak is not None:
            _, p = create_pressure_grid(
                sp, torch.as_tensor(np.asarray(grid.ak), dtype=torch.float32, device=y.device),
                torch.as_tensor(np.asarray(grid.bk), dtype=torch.float32, device=y.device))
        else:
            p = torch.as_tensor(np.asarray(grid.levels), dtype=torch.float32,
                                device=y.device).expand(t.shape)
        return self(t, dewpoint_from_q(q, p))

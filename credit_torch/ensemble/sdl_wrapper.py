"""SDL inference wrapper: per-layer noise control and a latent harness, port
of credit_tpu/ensemble/sdl_wrapper.py (reference:
credit/models/wxformer/sdl_inference_wrapper.py:36 -- hurricane track
stylization: directional/intensity noise retuning on the frozen pretrained
model, latent capture for exact forecast reproduction, latent
interpolation for smooth ensemble exploration).

The wrapped model is the port's `crossformer-ensemble`
(`models/sdl.py` CrossFormerWithNoise). Noise factors are its layers'
`noise_factor` parameters, set in place. A capture is the model's `noise=`
dict: the latent (the style vector's input) and each layer's pixel noise,
as the forward drew them; replaying it reproduces the forward exactly.
credit_tpu keeps the pixels and the key that draws the latent; here the
latent itself is kept.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from credit_torch.models.sdl import DECODER_NOISE, ENCODER_NOISE, StochasticDecompositionLayer

ENCODER_LAYERS = ENCODER_NOISE
DECODER_LAYERS = DECODER_NOISE
# manual control names (reference set_manual_factors: large/medium/fine map
# onto the decoder stages coarse->fine)
MANUAL_MAP = {"large_scale": "noise_inject1", "medium_scale": "noise_inject2",
              "fine_scale": "noise_inject3"}


class SDLInferenceWrapper:
    """Wraps a crossformer-ensemble model (put in eval mode) for inference."""

    def __init__(self, model):
        self.model = model.eval()
        self._original = {name: mod.noise_factor.detach().clone()
                          for name, mod in model.named_children()
                          if isinstance(mod, StochasticDecompositionLayer)}
        self._stored: Dict[str, Dict[str, torch.Tensor]] = {}

    # -- noise-factor control (reference :83-161) -----------------------
    def layer_names(self) -> List[str]:
        return sorted(self._original)

    def get_noise_factors(self) -> Dict[str, float]:
        return {n: getattr(self.model, n).noise_factor.item() for n in self.layer_names()}

    @torch.no_grad()
    def _set(self, names, factors):
        if isinstance(factors, (int, float)):
            factors = [factors] * len(names)
        if len(factors) != len(names):
            raise ValueError(f"expected {len(names)} factors, got {len(factors)}")
        for n, f in zip(names, factors):
            if n in self._original:
                getattr(self.model, n).noise_factor.fill_(float(f))

    def set_noise_factors(self, factors: Union[float, List[float]]):
        self._set(self.layer_names(), factors)

    def set_encoder_noise_factors(self, factors):
        self._set([n for n in ENCODER_LAYERS if n in self._original], factors)

    def set_decoder_noise_factors(self, factors):
        self._set([n for n in DECODER_LAYERS if n in self._original], factors)

    def set_manual_factors(self, large_scale: float, medium_scale: float, fine_scale: float):
        for key, val in (("large_scale", large_scale), ("medium_scale", medium_scale),
                         ("fine_scale", fine_scale)):
            self._set([MANUAL_MAP[key]], [val])

    def reset_to_original(self):
        self._set(list(self._original), [float(v) for v in self._original.values()])

    # -- latent capture / replay (reference :162-324) -------------------
    @torch.no_grad()
    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                capture: bool = False, latents: Optional[Dict[str, torch.Tensor]] = None):
        """One forward pass. capture=True returns (y, latents); latents=...
        replays stored noise exactly (the generator is unused then). Without
        either, the draws come from `generator` (one on x's device seeded 0
        when None, as credit_tpu's default key is PRNGKey(0))."""
        if latents is not None:
            return self.model(x, noise=latents)
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        if capture:
            drawn: Dict[str, torch.Tensor] = {}
            y = self.model(x, generator=generator, capture=drawn)
            return y, drawn
        return self.model(x, generator=generator)

    def store_latents(self, name: str, latents: Dict[str, torch.Tensor]):
        self._stored[name] = latents

    def get_stored_latents(self, name: str) -> Optional[Dict[str, torch.Tensor]]:
        return self._stored.get(name)

    def list_stored_latents(self) -> List[str]:
        return sorted(self._stored)

    def clear_stored_latents(self, name: Optional[str] = None):
        if name is None:
            self._stored.clear()
        else:
            self._stored.pop(name, None)

    def interpolate_latents(self, name1: str, name2: str, t: float) -> Dict[str, torch.Tensor]:
        """Lerp between two stored pixel-noise realizations, keeping the
        first one's latent (as credit_tpu keeps the first key): smooth
        trajectory morphing between ensemble members (reference :278)."""
        l1, l2 = self._stored[name1], self._stored[name2]
        out = {k: (1 - t) * v + t * l2[k] for k, v in l1.items() if k != "latent"}
        out["latent"] = l1["latent"]
        return out

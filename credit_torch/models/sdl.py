"""Stochastic decomposition layer and the noise-injection CrossFormer
ensemble: port of credit_tpu/models/sdl.py.

StyleGAN-style noise injection (reference:
credit/models/wxformer/stochastic_decomposition_layer.py:5 SDL, per-pixel
noise modulated by a style vector; crossformer_ensemble.py:9
CrossFormerWithNoise, SDL injection on the encoder skips and after each
decoder up-block). It is built from the CrossFormer's layers, so the
port's kernels carry it; the injection itself is an elementwise
multiply-add and one small linear layer in plain PyTorch. Under a mesh
with domain > 1 it runs the CrossFormer's lat-sharded forward: every
domain rank draws the latent and each layer's pixel noise of the whole
field, as one process does, and injects its slab's rows of it.

Noise comes from the `generator` passed to the forward (on the input's
device; torch's default generator when None), so CUDA and CPU draws differ
for one seed. The latent and each layer's pixel noise can also be passed
in (`noise=`), to replay draws made elsewhere: credit_tpu draws from its
flax 'noise' stream, and the tests feed those draws to the port. A
forward given a `capture` dict writes into it every draw it uses, which
is the `noise=` that replays it (the SDL inference wrapper's latents).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from credit_torch import registry
from credit_torch.models.base import channels_to_frames, frames_to_channels
from credit_torch.models.crossformer import CrossFormer
from credit_torch.models.layers import Dense
from credit_torch.ops.upsample import bilinear_resize
from credit_torch.parallel import context as par_ctx

# the injection points in credit_tpu's order of draws: the encoder skips
# (encodings 2, 1, 0), then after up-blocks 1-3
ENCODER_NOISE = ("encoder_noise0", "encoder_noise1", "encoder_noise2")
DECODER_NOISE = ("noise_inject1", "noise_inject2", "noise_inject3")


class StochasticDecompositionLayer(nn.Module):
    """feature + noise_factor * pixel * style(latent) * modulation, in f32.

    `noise_factor` is a parameter (reference: the SDL wrapper rewrites
    layer.noise_factor per layer), `modulation` one scale per channel,
    `noise_transform` the (noise_dim -> channels) linear map of the latent
    to the style, in the compute dtype."""

    def __init__(self, channels: int, noise_dim: int, noise_factor: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.noise_transform = Dense(noise_dim, channels, dtype=dtype, spectral=False)
        self.modulation = nn.Parameter(torch.ones(channels))
        self.noise_factor = nn.Parameter(torch.tensor(float(noise_factor)))

    def draw(self, feature: torch.Tensor, generator: Optional[torch.Generator] = None,
             rows: Optional[int] = None) -> torch.Tensor:
        """The pixel noise of `feature`'s shape that forward draws when it
        is given none; with `rows`, of that many latitude rows (the whole
        field's, where feature is a slab of it)."""
        shape = feature.shape if rows is None else (feature.shape[0], rows, *feature.shape[2:])
        return torch.randn(shape, generator=generator, device=feature.device, dtype=self.dtype)

    def forward(self, feature: torch.Tensor, latent: torch.Tensor,
                pixel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = feature.shape[-1]
        style = self.noise_transform(latent)
        style = style.reshape(feature.shape[0], *([1] * (feature.dim() - 2)), c)
        if pixel is None:
            pixel = self.draw(feature, generator)
        # credit_tpu promotes to f32 here (its factor and modulation are f32)
        return feature.float() + self.noise_factor * pixel.float() * style.float() * self.modulation


@registry.register("model", "crossformer-ensemble")
@registry.register("model", "crossformer-style")
class CrossFormerWithNoise(CrossFormer):
    """CrossFormer with SDL noise injection on the skips and the decoder
    stages (credit_tpu's defaults: a 128-wide latent, factors 0.05 on the
    encoder skips and 0.275 after the up-blocks)."""

    stochastic = True  # the train and eval steps pass their noise generator

    def __init__(self, noise_latent_dim: int = 128, encoder_noise_factor: float = 0.05,
                 decoder_noise_factor: float = 0.275, encoder_noise: bool = True, **kw):
        # credit_tpu's ensemble has its own forward: frames to channels and
        # the UpBlock decoder whatever the cube-embed, sub-pixel and sharp
        # keys say
        super().__init__(**{**kw, "patch_height": 1, "patch_width": 1,
                            "upsample_with_ps": False, "sharp_skip": False})
        dims, dt = self.dims, self.compute_dtype
        last = dims[-1]
        self.noise_latent_dim = noise_latent_dim
        self.encoder_noise = encoder_noise
        if encoder_noise:
            for name, ch in zip(ENCODER_NOISE, (dims[2], dims[1], dims[0])):
                self.add_module(name, StochasticDecompositionLayer(
                    ch, noise_latent_dim, encoder_noise_factor, dt))
        for name, ch in zip(DECODER_NOISE, (last // 2, last // 4, last // 8)):
            self.add_module(name, StochasticDecompositionLayer(
                ch, noise_latent_dim, decoder_noise_factor, dt))

    def forward(self, x: torch.Tensor, noise: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                capture: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """x: (B, T, H, W, C_in). noise: draws to replay, {"latent": (B,
        noise_latent_dim), <layer name>: that layer's pixel noise}; any draw
        it lacks comes from `generator`, the latent first, then the layers
        in credit_tpu's order. capture: a dict that receives the latent and
        every layer's pixels this forward uses."""
        noise = noise or {}
        latent = noise.get("latent")
        if latent is None:
            latent = torch.randn((x.shape[0], self.noise_latent_dim), generator=generator,
                                 device=x.device, dtype=self.compute_dtype)
        if capture is not None:
            capture["latent"] = latent

        def inject(name, feat, n_slabs=1):
            layer, pixel = getattr(self, name), noise.get(name)
            if pixel is None and (capture is not None or n_slabs > 1):
                pixel = layer.draw(feat, generator, feat.shape[1] * n_slabs)
            if capture is not None:
                capture[name] = pixel
            if n_slabs > 1:  # this rank's rows of the whole field's noise
                from credit_torch.parallel.halo import shard_lat

                pixel = shard_lat(pixel, n_slabs, par_ctx.mesh().coord("domain"))
            return layer(feat, latent, pixel, generator)

        if par_ctx.halo_mesh_active():
            names = {**({f"skip{i}": nm for nm, i in zip(ENCODER_NOISE, (2, 1, 0))}
                        if self.encoder_noise else {}),
                     **{f"up{i}": nm for i, nm in enumerate(DECODER_NOISE, 1)}}
            n = par_ctx.mesh().shape["domain"]
            return self._forward_slabs(
                x, lambda point, t, sh: (inject(names[point], t, n if sh else 1)
                                         if point in names else t),
                (self.image_height, self.image_width))
        if self.padder is not None:
            x = self.padder.pad(x)
        x = frames_to_channels(x)
        encodings = []
        for i in range(4):
            x = getattr(self, f"cel{i}")(x)
            x = getattr(self, f"transformer{i}")(x)
            encodings.append(x)
        if self.encoder_noise:
            for name, i in zip(ENCODER_NOISE, (2, 1, 0)):
                encodings[i] = inject(name, encodings[i])
        x = inject("noise_inject1", self.up_block1(x))
        x = torch.cat([x, encodings[2]], dim=-1)
        x = inject("noise_inject2", self.up_block2(x))
        x = torch.cat([x, encodings[1]], dim=-1)
        x = inject("noise_inject3", self.up_block3(x))
        x = torch.cat([x, encodings[0]], dim=-1)
        x = self.up_block4(x)
        if self.padder is not None:
            x = self.padder.unpad(x)
        if self.interp:  # credit_tpu's ensemble resizes to the input grid
            x = bilinear_resize(x, self.image_height, self.image_width)
        return channels_to_frames(x, self.output_frames)

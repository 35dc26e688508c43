"""Domain variants of the CrossFormer: port of credit_tpu/models/variants.py.

`camulator` is the CrossFormer with the zero-initialised 3x3 `sharp`
residual conv on the decoder output, outside spectral norm (no u/v);
`crossformer_downscaling` recovers onto `out_image_height/width` instead
of the input grid. The regional models are in models/regional.py.
"""

from __future__ import annotations

from credit_torch import registry
from credit_torch.models.crossformer import CrossFormer


@registry.register("model", "camulator")
class Camulator(CrossFormer):
    """CAM emulator: the CrossFormer with `sharp_skip` on by default."""

    def __init__(self, *args, sharp_skip: bool = True, **kw):
        super().__init__(*args, sharp_skip=sharp_skip, **kw)


@registry.register("model", "crossformer_downscaling")
class CrossFormerDownscaling(CrossFormer):
    """Downscaling head: the encoder runs on the source grid and the final
    bilinear recovery targets (out_image_height, out_image_width)."""

"""Key/shape manifests of the published CREDIT checkpoints and a seeded
state dict in their layout (port of credit_tpu/manifests.py, a copy of its
code and of its two JSON files under credit_torch/data/manifests/).

CREDIT publishes trained checkpoints on HuggingFace (wxformer_6h, fuxi_6h;
loaded by credit/models/base_model.py:57 load_state_dict). The manifests
hold the names and shapes of those state dicts, extracted from the CREDIT
model classes at the published configs, so the conversion into the port
(`convert_torch`) is checked end to end on a synthesized state dict with
the published layout:

    credit-torch convert-checkpoint cfg.yml --dry-run-manifest wxformer_6h
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

_DIR = os.path.join(os.path.dirname(__file__), "data", "manifests")

# the model config of each manifest (CREDIT's
# config/gen_1/arXiv_2024/{wxformer,fuxi}_6h_single_step.yml model sections)
MANIFEST_MODEL_CONF = {
    "wxformer_6h": {
        "type": "crossformer", "frames": 1, "image_height": 640,
        "image_width": 1280, "levels": 16, "channels": 4,
        "surface_channels": 7, "input_only_channels": 3,
        "output_only_channels": 0, "patch_width": 1, "patch_height": 1,
        "frame_patch_size": 1, "dim": [128, 256, 512, 1024],
        "depth": [2, 2, 8, 2], "global_window_size": [10, 5, 2, 1],
        "local_window_size": 10,
        "cross_embed_kernel_sizes": [[4, 8, 16, 32], [2, 4], [2, 4], [2, 4]],
        "cross_embed_strides": [2, 2, 2, 2], "use_spectral_norm": True,
        "interp": True,
        "padding_conf": {"activate": True, "mode": "earth",
                         "pad_lat": [80, 80], "pad_lon": [80, 80]},
    },
    "fuxi_6h": {
        "type": "fuxi", "frames": 2, "frame_patch_size": 2,
        "image_height": 640, "image_width": 1280, "patch_height": 4,
        "patch_width": 4, "levels": 16, "channels": 4,
        "surface_channels": 7, "input_only_channels": 3,
        "output_only_channels": 0, "dim": 1024, "num_groups": 32,
        "num_heads": 8, "window_size": 7, "depth": 16,
        "use_spectral_norm": True, "interp": True,
        "padding_conf": {"activate": True, "mode": "earth",
                         "pad_lat": [80, 80], "pad_lon": [80, 80]},
    },
}


def available() -> List[str]:
    return sorted(f[:-5] for f in os.listdir(_DIR) if f.endswith(".json"))


def load_manifest(name: str) -> Dict[str, List[int]]:
    path = os.path.join(_DIR, f"{name}.json")
    if not os.path.exists(path):
        raise KeyError(f"no manifest {name!r}; available: {available()}")
    with open(path) as f:
        return json.load(f)


def synthesize_state_dict(name: str, seed: int = 0):
    """A torch state dict with the manifest's keys and shapes and small
    seeded values (N(0, 0.02) from one CPU generator, in the manifest's key
    order), shaped like the published checkpoint, so the converter's key
    mapping and transposes are checked end to end."""
    import torch

    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in load_manifest(name).items():
        t = torch.empty(*shape) if shape else torch.empty(())
        out[k] = t.normal_(0.0, 0.02, generator=g)
    return out

"""Ocean emulation (Samudra) support: constants + data utilities (port of
credit_tpu/ocean.py, a copy of its numpy code).

credit_tpu re-designs the reference's ocean module
(reference: credit/ocean/samudra_constants.py — depth levels, wet-mask
variable names, prognostic/boundary variable maps; samudra_data.py:17
extract_wet_mask / :40 get_inference_steps) for the flat channels-last
pipeline: wet masks become (lat, lon, C) channel masks aligned with the
ChannelSchema, and the noleap inference-step count rides the port's CF
clock (credit_torch/data/timeclock.py) instead of cftime.

The Samudra trainer itself is the gen2 trainer (loss masking through the
wet-mask channels + the 'wet_mask' postblock); this module supplies the
domain constants and mask plumbing.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# reference: samudra_constants.py DEPTH_I_LEVELS (19 interface levels, m)
DEPTH_I_LEVELS = ["2_5", "10_0", "22_5", "40_0", "65_0", "105_0", "165_0",
                  "250_0", "375_0", "550_0", "775_0", "1050_0", "1400_0",
                  "1850_0", "2400_0", "3100_0", "4000_0", "5000_0", "6000_0"]

MASK_VARS = [f"wetmask_{d}" for d in DEPTH_I_LEVELS]

PROG_VARS_MAP: Dict[str, List[str]] = {
    "thermo_dynamic": [k + d for k in ("uo_", "vo_", "thetao_", "so_")
                       for d in DEPTH_I_LEVELS] + ["zos"],
    "thermo": [k + d for k in ("thetao_", "so_")
               for d in DEPTH_I_LEVELS] + ["zos"],
}

BOUND_VARS_MAP: Dict[str, List[str]] = {
    "hfds_anom": ["tauuo", "tauvo", "hfds", "hfds_anomalies"],
    "hfds": ["tauuo", "tauvo", "hfds"],
}


def depth_index(var_name: str) -> int:
    """'thetao_2_5' -> depth level index; surface-only vars -> 0
    (reference: samudra_data.py:27-33 split('_')[-1] parsing; the reference
    uses the numeric suffix directly as the wet-mask row)."""
    for i, d in enumerate(DEPTH_I_LEVELS):
        if var_name.endswith("_" + d):
            return i
    return 0


def extract_wet_mask(masks: Dict[str, np.ndarray],
                     outputs: Sequence[str], hist: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel wet mask + surface mask.

    masks: {wetmask_<depth>: (lat, lon)} (time dim already selected).
    outputs: output variable names in channel order.
    Returns (wet (lat, lon, C*(hist+1)), wet_surface (lat, lon)) —
    channels-last, ready to multiply into flat prediction tensors
    (reference returns channel-first torch tensors; same content)."""
    rows = [np.asarray(masks[MASK_VARS[depth_index(v)]], np.float32)
            for v in outputs]
    wet = np.stack(rows, axis=-1)
    wet = np.concatenate([wet] * (hist + 1), axis=-1)
    surface = np.asarray(masks[MASK_VARS[0]], np.float32)
    return wet, surface


def get_inference_steps(start_time: str, end_time: str, time_delta: int = 5,
                        hist: int = 1, calendar: str = "noleap") -> int:
    """Rollout step count on the (noleap) ocean clock
    (reference: samudra_data.py:40 — days/time_delta + 1, truncated to a
    multiple of hist+1)."""
    from credit_torch.data.timeclock import parse_datetime

    t0 = parse_datetime(start_time, calendar)
    t1 = parse_datetime(end_time, calendar)
    days = int((t1 - t0) / np.timedelta64(86400, "s"))
    num = days // time_delta + 1
    return num - num % (hist + 1)

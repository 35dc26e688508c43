"""Channel layout contract for flat model tensors: the port's copy of
credit_tpu/data/channels.py (`ChannelSchema`).

Canonical concat order: sources in config order; within each source the
field types ranked prognostic < static < dynamic_forcing (diagnostics are
target-only); 3-D vars (x levels) before 2-D vars; config order within.
Channels-last layout: tensors are (..., lat, lon, C).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

FIELD_TYPE_RANK = {"prognostic": 0, "static": 1, "dynamic_forcing": 2, "diagnostic": 3}
TARGET_RANK = {"prognostic": 0, "diagnostic": 1}


@dataclasses.dataclass(frozen=True)
class ChannelEntry:
    name: str
    source: str
    field_type: str
    index: int


@dataclasses.dataclass
class ChannelSchema:
    """Frozen flat-tensor channel layout for model input and target."""

    input_entries: List[ChannelEntry]
    target_entries: List[ChannelEntry]
    input_slices: Dict[str, slice]
    target_slices: Dict[str, slice]
    n_levels: int

    @property
    def n_input(self) -> int:
        return len(self.input_entries)

    @property
    def n_target(self) -> int:
        return len(self.target_entries)

    @property
    def n_prognostic(self) -> int:
        sl = self.input_slices.get("prognostic")
        return 0 if sl is None else sl.stop - sl.start

    @property
    def input_names(self) -> List[str]:
        return [e.name for e in self.input_entries]

    @property
    def target_names(self) -> List[str]:
        return [e.name for e in self.target_entries]

    @classmethod
    def from_config(cls, conf: dict) -> "ChannelSchema":
        sources = conf["data"]["source"]
        input_entries: List[ChannelEntry] = []
        target_entries: List[ChannelEntry] = []
        n_levels = 0

        def expand(src, ftype, grp):
            nonlocal n_levels
            out = []
            lv = len(sources[src].get("levels", [])) or 1
            if ftype == "prognostic":
                n_levels = max(n_levels, lv)
            for v in grp.get("vars_3D", []) or []:
                out.extend((f"{v}_L{k}", src, ftype) for k in range(lv))
            for v in grp.get("vars_2D", []) or []:
                out.append((v, src, ftype))
            return out

        for src_name, src in sources.items():
            variables = src.get("variables", {})
            in_groups = sorted(((ft, g) for ft, g in variables.items()
                                if g is not None and ft != "diagnostic"),
                               key=lambda p: FIELD_TYPE_RANK.get(p[0], 99))
            for ft, g in in_groups:
                for name, s, f in expand(src_name, ft, g):
                    input_entries.append(ChannelEntry(name, s, f, len(input_entries)))
            tgt_groups = sorted(((ft, g) for ft, g in variables.items()
                                 if g is not None and ft in TARGET_RANK),
                                key=lambda p: TARGET_RANK[p[0]])
            for ft, g in tgt_groups:
                for name, s, f in expand(src_name, ft, g):
                    target_entries.append(ChannelEntry(name, s, f, len(target_entries)))

        return cls(input_entries, target_entries, _field_slices(input_entries),
                   _field_slices(target_entries), n_levels)

    def input_segments(self):
        """Ordered contiguous (source, field_type, start, stop) runs of the
        input layout."""
        return _segments(self.input_entries)

    def target_segments(self):
        return _segments(self.target_entries)

    def dynamic_forcing_indices(self) -> List[int]:
        return [e.index for e in self.input_entries if e.field_type == "dynamic_forcing"]

    def update_x(self, x_prev: torch.Tensor, y_pred: torch.Tensor,
                 new_forcing: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Autoregressive splice for the next step: prognostic channels from
        y_pred, dynamic_forcing from new_forcing (when given), the rest
        carried from x_prev; per contiguous (source, type) run.

        x_prev: (..., C_in); y_pred: (..., C_target);
        new_forcing: (..., n_dyn) in dynamic_forcing_indices order, or None.
        """
        tgt_prog = {src: (a, b) for src, ft, a, b in self.target_segments()
                    if ft == "prognostic"}
        parts = []
        dyn_cursor = 0
        for src, ftype, a, b in self.input_segments():
            if ftype == "prognostic":
                ta, tb = tgt_prog[src]
                parts.append(y_pred[..., ta:tb])
            elif ftype == "dynamic_forcing" and new_forcing is not None:
                n = b - a
                parts.append(new_forcing[..., dyn_cursor:dyn_cursor + n])
                dyn_cursor += n
            else:
                parts.append(x_prev[..., a:b])
        return torch.cat(parts, dim=-1)


def _field_slices(entries):
    out = {}
    for e in entries:
        if e.field_type not in out:
            out[e.field_type] = [e.index, e.index + 1]
        else:
            out[e.field_type][1] = e.index + 1
    return {k: slice(a, b) for k, (a, b) in out.items()}


def _segments(entries):
    segs = []
    for e in entries:
        if segs and segs[-1][0] == e.source and segs[-1][1] == e.field_type \
                and segs[-1][3] == e.index:
            segs[-1][3] = e.index + 1
        else:
            segs.append([e.source, e.field_type, e.index, e.index + 1])
    return [tuple(s) for s in segs]

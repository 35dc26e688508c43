"""Graph transformer GRU: port of credit_tpu/models/graph.py (`graph`).

The nodes are the flattened lat-lon grid, the edges its k nearest
neighbours on the unit sphere (`knn_sphere_edges`, numpy, built at
construction, the same edges in the same order as credit_tpu's). Each
block is a TransformerConv by segment softmax and segment sum over the
static edge list (`scatter_reduce` amax and `index_add_`), ReLU, Dense,
LayerNorm (eps 1e-6), ReLU, Dense, plus the residual; a GRU-style gate
follows each block (the first from the block's output alone). Batch
samples share the graph. Parameter names follow flax's `setup`:
`encoder`, `blocks_<i>`, `gates_<i>`, `decoder`.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from credit_torch import registry
from credit_torch.models.base import DTYPES, BaseModel
from credit_torch.models.layers import Dense, LayerNorm


def knn_sphere_edges(lat_deg: np.ndarray, lon_deg: np.ndarray, k: int = 8
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(edge_src, edge_dst) int32 of each node's k nearest neighbours on the
    unit sphere by cosine similarity, in blocks of 2048 rows (a copy of
    credit_tpu's, so that the edges and their order agree)."""
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    xyz = np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                    np.sin(la)], axis=-1).reshape(-1, 3)
    n = xyz.shape[0]
    src_list, dst_list = [], []
    block = 2048
    for start in range(0, n, block):
        d = xyz[start:start + block] @ xyz.T
        idx = np.argpartition(-d, k + 1, axis=1)[:, :k + 1]
        for row, neigh in enumerate(idx):
            i = start + row
            for j in neigh:
                if j != i:
                    src_list.append(j)
                    dst_list.append(i)
    return np.asarray(src_list, np.int32), np.asarray(dst_list, np.int32)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
                ) -> torch.Tensor:
    """Sum of values (B, E, ...) over edges into (B, num_segments, ...)."""
    out = values.new_zeros((values.shape[0], num_segments, *values.shape[2:]))
    return out.index_add_(1, segment_ids, values)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
                    ) -> torch.Tensor:
    """Softmax of logits (B, E, H) over the edges of each destination node,
    exp / (sum + 1e-9) as credit_tpu's."""
    b, e, h = logits.shape
    idx = segment_ids[None, :, None].expand(b, e, h)
    maxes = logits.new_full((b, num_segments, h), -math.inf).scatter_reduce(
        1, idx, logits, "amax", include_self=False)
    ex = torch.exp(logits - maxes.gather(1, idx))
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / (denom.gather(1, idx) + 1e-9)


def _dense(i: int, o: int, dtype, use_bias: bool = True) -> Dense:
    return Dense(i, o, use_bias=use_bias, dtype=dtype, spectral=False)


class GraphTransformerConv(nn.Module):
    """TransformerConv (Shi et al. 2021): per destination node, the softmax
    of q . k / sqrt(c) over its incoming edges weights the sources' values,
    plus a skip projection. x (B, N, C) -> (B, N, heads * c)."""

    def __init__(self, in_ch: int, out_channels: int, heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        hc = heads * out_channels
        self.lin_query = _dense(in_ch, hc, dtype)
        self.lin_key = _dense(in_ch, hc, dtype)
        self.lin_value = _dense(in_ch, hc, dtype)
        self.lin_skip = _dense(in_ch, hc, dtype)

    def forward(self, x, edge_src, edge_dst):
        b, n, _ = x.shape
        h, c = self.heads, self.out_channels
        q, k, v = self.lin_query(x), self.lin_key(x), self.lin_value(x)
        qe = q[:, edge_dst].reshape(b, -1, h, c)
        ke = k[:, edge_src].reshape(b, -1, h, c)
        ve = v[:, edge_src].reshape(b, -1, h, c)
        logits = (qe * ke).sum(-1) / math.sqrt(float(c))
        alpha = segment_softmax(logits, edge_dst, n)
        msg = (ve * alpha[..., None]).reshape(b, -1, h * c)
        return segment_sum(msg, edge_dst, n) + self.lin_skip(x)


class GateCell(nn.Module):
    """GRU-style gate. The first gate (no previous state) has z_x, r_x and
    h_x and returns tanh(h_x(x)); the later ones z_x, r_x, z_h, r_h, h_h."""

    def __init__(self, hidden_size: int, first: bool, dtype=torch.float32):
        super().__init__()
        d = hidden_size
        self.first = first
        self.z_x = _dense(d, d, dtype)
        self.r_x = _dense(d, d, dtype)
        if first:
            self.h_x = _dense(d, d, dtype)
        else:
            self.z_h = _dense(d, d, dtype)
            self.r_h = _dense(d, d, dtype)
            self.h_h = _dense(d, d, dtype)

    def forward(self, x, hprev: Optional[torch.Tensor]):
        if self.first:
            # z_x and r_x exist (the reference creates them) but do not
            # reach the output of the first gate
            return torch.tanh(self.h_x(x))
        z = torch.sigmoid(self.z_x(x) + self.z_h(hprev))
        r = torch.sigmoid(self.r_x(x) + self.r_h(hprev))
        h_hat = torch.tanh(self.h_h(r * hprev))
        return (1 - z) * hprev + z * h_hat


class GraphBlock(nn.Module):
    """TransformerConv -> ReLU -> Dense -> LayerNorm -> ReLU -> Dense, plus
    the residual."""

    def __init__(self, hidden_size: int, heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.transformer = GraphTransformerConv(hidden_size, hidden_size // heads, heads, dtype)
        hc = heads * (hidden_size // heads)
        self.physics_linear = _dense(hc, hidden_size, dtype)
        self.norm = LayerNorm(hidden_size, eps=1e-6, dtype=dtype)
        self.merge_linear = _dense(hidden_size, hidden_size, dtype)

    def forward(self, x, edge_src, edge_dst):
        t = torch.relu(self.transformer(x, edge_src, edge_dst))
        t = torch.relu(self.norm(self.physics_linear(t)))
        return self.merge_linear(t) + x


@registry.register("model", "graph")
class GraphResTransfGRU(BaseModel):
    """(B, T, H, W, C_in) -> (B, T_out, H, W, C_out) on the kNN graph of the
    regular grid (latitudes 90 to -90, longitudes from 0)."""

    def __init__(self, image_height: int = 181, image_width: int = 360, frames: int = 1,
                 output_frames: int = 1, channels: int = 4, surface_channels: int = 4,
                 input_only_channels: int = 0, output_only_channels: int = 0, levels: int = 15,
                 hidden_size: int = 256, n_blocks: int = 4, heads: int = 4, knn: int = 6,
                 compute_dtype: Any = torch.float32, sn_state: bool = False):
        super().__init__()
        dt = DTYPES[compute_dtype] if isinstance(compute_dtype, str) else compute_dtype
        self.output_frames, self.n_blocks = output_frames, n_blocks
        self.base_input_channels = channels * levels + surface_channels + input_only_channels
        self.base_output_channels = channels * levels + surface_channels + output_only_channels
        lat = np.linspace(90.0, -90.0, image_height)
        lon = np.linspace(0.0, 360.0, image_width, endpoint=False)
        src, dst = knn_sphere_edges(lat, lon, knn)
        self.register_buffer("edge_src", torch.from_numpy(src.astype(np.int64)),
                             persistent=False)
        self.register_buffer("edge_dst", torch.from_numpy(dst.astype(np.int64)),
                             persistent=False)
        self.encoder = _dense(self.base_input_channels * frames, hidden_size, dt)
        for i in range(n_blocks):
            self.add_module(f"blocks_{i}", GraphBlock(hidden_size, heads, dt))
            self.add_module(f"gates_{i}", GateCell(hidden_size, i == 0, dt))
        self.decoder = _dense(hidden_size, self.base_output_channels * output_frames, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, hh, ww, c = x.shape
        h = self.encoder(x.permute(0, 2, 3, 4, 1).reshape(b, hh * ww, c * t))
        state = None
        for i in range(self.n_blocks):
            h = getattr(self, f"blocks_{i}")(h, self.edge_src, self.edge_dst)
            state = getattr(self, f"gates_{i}")(h, state)
            h = state
        out = self.decoder(h).reshape(b, hh, ww, self.base_output_channels, self.output_frames)
        return out.permute(0, 4, 1, 2, 3)

"""Graph transformer GRU: port of credit_tpu/models/graph.py (`graph`).

The nodes are the flattened lat-lon grid, the edges its k nearest
neighbours on the unit sphere (`knn_sphere_edges`, numpy, built at
construction, the same edges in the same order as credit_tpu's). Each
block is a TransformerConv by segment softmax and segment sum over the
static edge list, ReLU, Dense, LayerNorm (eps 1e-6), ReLU, Dense, plus
the residual; a GRU-style gate follows each block (the first from the
block's output alone). Batch samples share the graph. Parameter names
follow flax's `setup`: `encoder`, `blocks_<i>`, `gates_<i>`, `decoder`.

The segment sums, and the backward of every gather by an edge's node, add
each node's edges in edge order (`Segments`: the edge list grouped by
destination and by source once, the nodes of each degree together, a
gather and a dense sum), so a step's gradient is the same bits on every
call, on the card as on the CPU.

Under a mesh with domain > 1 the forward is lat-sharded (`_forward_slabs`):
a domain rank owns the nodes of its latitude slab and the edges into them
(a contiguous run of the edge list, which is built destination by
destination), whose sources lie within `edge_halo` rows of their
destination's row (the largest such distance in the edge list). Before
each block the node features are extended by that many rows of each
neighbour (`halo_exchange`); the edges index the extended slab
(`slab_edges`). The segment ops stay local (their segments are
destination nodes); encoder, gates and decoder are per node. The
decoder's output is gathered.
"""

from __future__ import annotations

import concurrent.futures
import functools
import math
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from credit_torch import registry
from credit_torch.models.base import DTYPES, BaseModel
from credit_torch.models.layers import Dense, LayerNorm
from credit_torch.parallel import context as par_ctx


def knn_sphere_edges(lat_deg: np.ndarray, lon_deg: np.ndarray, k: int = 8
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(edge_src, edge_dst) int32 of each node's k nearest neighbours on the
    unit sphere by cosine similarity, in blocks of 2048 rows (credit_tpu's
    computation, so that the edges and their order agree), the blocks on
    the host's cores."""
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    xyz = np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                    np.sin(la)], axis=-1).reshape(-1, 3)
    n = xyz.shape[0]
    block = 2048

    def edges(start):  # each row's neighbours but itself, in argpartition's order
        d = xyz[start:start + block] @ xyz.T
        idx = np.argpartition(-d, k + 1, axis=1)[:, :k + 1]
        dst = np.arange(start, start + idx.shape[0])[:, None].repeat(k + 1, axis=1)
        keep = idx != dst
        return idx[keep], dst[keep]

    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        parts = list(pool.map(edges, range(0, n, block)))
    return (np.concatenate([p[0] for p in parts]).astype(np.int32),
            np.concatenate([p[1] for p in parts]).astype(np.int32))


@functools.lru_cache(maxsize=4)
def grid_edges(image_height: int, image_width: int, knn: int) -> Tuple[np.ndarray, np.ndarray]:
    """`knn_sphere_edges` of the regular grid (latitudes 90 to -90,
    longitudes from 0), once a process per grid (read-only arrays)."""
    lat = np.linspace(90.0, -90.0, image_height)
    lon = np.linspace(0.0, 360.0, image_width, endpoint=False)
    edges = knn_sphere_edges(lat, lon, knn)
    for a in edges:
        a.setflags(write=False)
    return edges


class Segments:
    """The edges of a static edge list grouped by the node they point at
    (`ids`, E int64 in [0, num)), for segment ops whose sums run in a fixed
    order on every device and every call. The nodes are grouped by degree:
    `groups[i]` (n_i, d_i) holds the edge positions of the n_i nodes of
    degree d_i, each row in edge order, and `where` (num,) the row of each
    node in the groups' results laid end to end (one past them, a zero
    row, for a node without edges). A sum over the edges is then a gather
    and a dense sum over d_i a group, and its adjoint a gather by `ids`: no
    atomics, forward or backward, where `index_add_` and the backward of
    indexing sum in the order their atomics land. No group is padded, so a
    node of high degree (a pole's source nodes on a lat-lon grid reach a
    whole row) costs only its own edges."""

    def __init__(self, ids: torch.Tensor, num: int):
        ids = ids.long()
        order = torch.argsort(ids, stable=True)
        counts = torch.bincount(ids, minlength=num)
        starts = torch.cumsum(counts, 0) - counts
        self.groups, nodes = [], []
        for d in torch.unique(counts).tolist():
            if d:
                nd = torch.nonzero(counts == d).flatten()
                self.groups.append(order[starts[nd, None]
                                         + torch.arange(d, device=ids.device)])
                nodes.append(nd)
        placed = torch.cat(nodes) if nodes else ids.new_zeros(0)
        self.where = torch.full((num,), placed.numel(), dtype=torch.long, device=ids.device)
        self.where[placed] = torch.arange(placed.numel(), device=ids.device)
        self.ids, self.num = ids, num

    def reduce(self, values: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """values (B, E, ...) -> (B, num, ...): each node's edges reduced
        (`sum` or `amax`) in edge order; 0 where a node has none."""
        b, rest = values.shape[0], values.shape[2:]
        parts = [getattr(values.index_select(1, g.flatten()).view(b, *g.shape, *rest), op)(2)
                 for g in self.groups]
        parts.append(values.new_zeros((b, 1, *rest)))
        return torch.cat(parts, 1).index_select(1, self.where)


def _segments(segment_ids, num_segments: int) -> Segments:
    return (segment_ids if isinstance(segment_ids, Segments)
            else Segments(segment_ids, num_segments))


class _SegmentSum(torch.autograd.Function):
    """`Segments.reduce`'s sum; backward the gather of the cotangent by
    each edge's node."""

    @staticmethod
    def forward(ctx, values, seg):
        ctx.seg = seg
        return seg.reduce(values)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(1, ctx.seg.ids), None


class _Gather(torch.autograd.Function):
    """x (B, num, ...) -> x[:, ids] (B, E, ...); backward the fixed-order
    segment sum of the cotangent over each node's edges."""

    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return x.index_select(1, seg.ids)

    @staticmethod
    def backward(ctx, g):
        return ctx.seg.reduce(g), None


def gather(x: torch.Tensor, segment_ids, num_segments: int) -> torch.Tensor:
    """x (B, num_segments, ...) at each edge's node, (B, E, ...)."""
    return _Gather.apply(x, _segments(segment_ids, num_segments))


def segment_sum(values: torch.Tensor, segment_ids, num_segments: int) -> torch.Tensor:
    """Sum of values (B, E, ...) over edges into (B, num_segments, ...), each
    node's edges added in edge order (`segment_ids` a tensor or `Segments`)."""
    return _SegmentSum.apply(values, _segments(segment_ids, num_segments))


def segment_softmax(logits: torch.Tensor, segment_ids, num_segments: int) -> torch.Tensor:
    """Softmax of logits (B, E, H) over the edges of each destination node,
    exp / (sum + 1e-9) as credit_tpu's. The segment's max only shifts the
    exponents, so no gradient is taken through it."""
    seg = _segments(segment_ids, num_segments)
    with torch.no_grad():
        maxes = seg.reduce(logits, "amax").index_select(1, seg.ids)
    ex = torch.exp(logits - maxes)
    denom = segment_sum(ex, seg, num_segments)
    return ex / (gather(denom, seg, num_segments) + 1e-9)


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

    def forward(self, x, edge_src, edge_dst, x_src=None):
        """x (B, N, C) the destination nodes; `x_src` the nodes edge_src
        indexes where they differ (a slab extended by its halo rows). The
        edges are index tensors or `Segments` (the model passes those)."""
        b, n, _ = x.shape
        h, c = self.heads, self.out_channels
        xs = x if x_src is None else x_src
        src, dst = _segments(edge_src, xs.shape[1]), _segments(edge_dst, n)
        q, k, v = self.lin_query(x), self.lin_key(xs), self.lin_value(xs)
        qe = gather(q, dst, n).reshape(b, -1, h, c)
        ke = gather(k, src, xs.shape[1]).reshape(b, -1, h, c)
        ve = gather(v, src, xs.shape[1]).reshape(b, -1, h, c)
        logits = (qe * ke).sum(-1) / math.sqrt(float(c))
        alpha = segment_softmax(logits, dst, n)
        msg = (ve * alpha[..., None]).reshape(b, -1, h * c)
        return segment_sum(msg, dst, n) + self.lin_skip(x)


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

    def forward(self, x, edge_src, edge_dst, x_src=None):
        t = torch.relu(self.transformer(x, edge_src, edge_dst, x_src))
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
        src, dst = grid_edges(image_height, image_width, knn)
        self.grid_shape = (image_height, image_width)
        # the largest latitude distance, in rows, from an edge's source to
        # its destination: the halo a latitude slab needs
        self.edge_halo = (int(np.abs(src // image_width - dst // image_width).max())
                          if len(src) else 0)
        self._slab_edges, self._segments = {}, {}
        self.register_buffer("edge_src", torch.from_numpy(src.astype(np.int64)),
                             persistent=False)
        self.register_buffer("edge_dst", torch.from_numpy(dst.astype(np.int64)),
                             persistent=False)
        self.encoder = _dense(self.base_input_channels * frames, hidden_size, dt)
        for i in range(n_blocks):
            self.add_module(f"blocks_{i}", GraphBlock(hidden_size, heads, dt))
            self.add_module(f"gates_{i}", GateCell(hidden_size, i == 0, dt))
        self.decoder = _dense(hidden_size, self.base_output_channels * output_frames, dt)

    # the forward splits latitude over the domain ranks (_forward_slabs)
    lat_sharded = True

    def slab_edges(self, n: int, r: int):
        """(edge_src, edge_dst) of domain rank r of n: the edges into its
        slab's nodes, their sources indexed in the slab extended by
        `edge_halo` rows a side, their destinations in the slab (cached per
        (n, r))."""
        key = (n, r, self.edge_dst.device)
        if key not in self._slab_edges:
            hh, ww = self.grid_shape
            rows = hh // n
            dst = self.edge_dst
            keep = (dst >= r * rows * ww) & (dst < (r + 1) * rows * ww)
            self._slab_edges[key] = (self.edge_src[keep] - (r * rows - self.edge_halo) * ww,
                                     dst[keep] - r * rows * ww)
        return self._slab_edges[key]

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        b, t, hh, ww, c = x.shape
        return self.encoder(x.permute(0, 2, 3, 4, 1).reshape(b, hh * ww, c * t))

    def _decode(self, h: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
        """(B, T_out, hh, ww, C_out)."""
        out = self.decoder(h).reshape(h.shape[0], hh, ww, self.base_output_channels,
                                      self.output_frames)
        return out.permute(0, 4, 1, 2, 3)

    def _blocks(self, h, edge_src, edge_dst, extend=None):
        state = None
        for i in range(self.n_blocks):
            h = getattr(self, f"blocks_{i}")(h, edge_src, edge_dst,
                                             None if extend is None else extend(h))
            state = getattr(self, f"gates_{i}")(h, state)
            h = state
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if par_ctx.halo_mesh_active():
            return self._forward_slabs(x)
        return self._whole(x)

    def segments(self, src: torch.Tensor, dst: torch.Tensor, n_src: int, n_dst: int, key):
        """The edges (src, dst) grouped by source over n_src nodes and by
        destination over n_dst (`Segments`), built once a key and device."""
        key = (key, dst.device)
        if key not in self._segments:
            self._segments[key] = (Segments(src, n_src), Segments(dst, n_dst))
        return self._segments[key]

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        hh, ww = x.shape[2], x.shape[3]
        src, dst = self.segments(self.edge_src, self.edge_dst, hh * ww, hh * ww, "whole")
        return self._decode(self._blocks(self._encode(x), src, dst), hh, ww)

    def _forward_slabs(self, x: torch.Tensor) -> torch.Tensor:
        """forward with latitude split over the mesh's domain ranks (see
        the module); the same function of x on every domain rank. Where the
        rows do not split, or a slab is shorter than the halo, each rank
        runs the whole graph (the gather path, counted as "graph")."""
        from credit_torch.parallel.halo import gather_lat, halo_exchange, scale_grad, shard_lat

        group, n, r = par_ctx.mesh_domain()
        hh, ww = x.shape[2], x.shape[3]
        rows = hh // n
        if hh % n or rows < self.edge_halo:
            par_ctx.GATHERS["graph"] += 1
            return scale_grad(self._whole(x), 1.0 / n)
        src, dst = self.segments(*self.slab_edges(n, r), (rows + 2 * self.edge_halo) * ww,
                                 rows * ww, (n, r))

        def extend(h):  # (B, rows * W, C) -> (B, (rows + 2 halo) * W, C)
            b, _, c = h.shape
            he = halo_exchange(h.reshape(b, rows, ww, c), self.edge_halo, group)
            return he.reshape(b, -1, c)

        h = self._blocks(self._encode(shard_lat(x, n, r)), src, dst, extend)
        return gather_lat(self._decode(h, rows, ww), group, same_downstream=True)

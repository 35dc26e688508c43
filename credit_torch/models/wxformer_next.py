"""NextGen WXFormer: port of credit_tpu/models/wxformer_next.py.

Per input frame, a learned per-(variable, level) bias and column attention
across the pressure levels of each location on the atmospheric channels,
the frames stacked time-major; the CrossFormer's four (cross-embed,
transformer) stages; a spectral-GNN bottleneck (N grid nodes pooled onto K
learned virtual nodes, a channel MLP, scattered back); three UpBlockPS
with bilinear alignment and U-Net skip concats; a 3x3 sub-pixel head,
pixel shuffle, bilinear recovery of the grid, plus the persistence
residual (the last frame's first output channels). Input
(B, T, H, W, C_in), output (B, 1, H, W, C_out).

Column attention is flax's MultiHeadDotProductAttention (no bias): the
`query`/`key`/`value` kernels (C, heads, C // heads) and the `out` kernel
(heads, C // heads, C) keep their DenseGeneral shapes, and the attention
itself is plain PyTorch (no TPU kernel computes it). The bottleneck's `agg_w` (K, N) and `scatter_w` (N, K) are sized by
the stage-3 node count, which the reference reads at call time: here it
comes from the cross-embed arithmetic at construction.

Under a mesh with domain > 1 the forward is lat-sharded (`_forward_slabs`,
after the CrossFormer's): each domain rank takes its latitude slab of the
input; the level embedding and column attention (per location) run on
it, then the four stages while their rows split (a stage whose rows do
not is gathered, and the up path cuts the field back to slabs at the
first skip that is one), the bottleneck, the UpBlockPS and the head. On
a slab the bottleneck takes GroupNorm's moments over every rank's rows,
pools this rank's nodes with its columns of `agg_w` and sums the pooled
nodes over the ranks (an all-reduce, forward and backward: a rank's
normalized nodes need the whole pooled gradient), runs the channel MLP
on the sum on every rank and scatters onto its nodes with its rows of
`scatter_w`. The head's output is gathered; every rank resizes it and
adds the persistence residual.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from credit_torch import registry
from credit_torch.models.base import DTYPES, BaseModel, channels_to_frames
from credit_torch.models.crossformer import _tup
from credit_torch.models.layers import (Conv, CrossEmbedLayer, Dense, LayerNorm, Transformer,
                                        UpBlockPS, _param)
from credit_torch.ops.upsample import bilinear_resize, pixel_shuffle
from credit_torch.parallel import context as par_ctx


class LevelEmbedding(nn.Module):
    """Learned bias per atmospheric (variable, level) channel."""

    def __init__(self, n: int):
        super().__init__()
        self.bias = _param(n)

    def forward(self, x):
        return x + self.bias


class DenseGeneral(nn.Module):
    """flax DenseGeneral without bias: `kernel` of any shape, applied by an
    einsum `spec` (input, kernel -> output)."""

    spectral = False

    def __init__(self, shape: Sequence[int], spec: str, fan_in: int, dtype=torch.float32):
        super().__init__()
        self.kernel = _param(*shape)
        self.spec, self.dtype = spec, dtype
        self.kernel_init = ("he_uniform", fan_in)

    def forward(self, x):
        return torch.einsum(self.spec, x.to(self.dtype), self.kernel.to(self.dtype))


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention of flax's MultiHeadDotProductAttention (use_bias False,
    qkv features = the input's): (N, L, C) -> (N, L, C)."""

    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        hd = dim // heads
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((dim, heads, hd), "nlc,chd->nhld", dim, dtype))
        self.out = DenseGeneral((heads, hd, dim), "nhld,hdc->nlc", dim, dtype)

    def forward(self, x):
        # explicit products: PyTorch's SDPA kernels put batch x heads on a
        # grid axis that a million columns overflow, and the columns are
        # 13 levels long; the softmax in f32
        q, k, v = self.query(x), self.key(x), self.value(x)
        q = q * q.shape[-1] ** -0.5
        w = torch.softmax(torch.einsum("nhld,nhmd->nhlm", q, k).float(), dim=-1)
        return self.out(torch.einsum("nhlm,nhmd->nhld", w.to(v.dtype), v))


class ColumnAttention(nn.Module):
    """Multi-head attention across the pressure levels at each location, on
    (B, H, W, channels * levels) variable-major channels, with an optional
    spatial average pool (stride s) whose output is resized back."""

    def __init__(self, channels: int, levels: int, num_heads: int = 4, spatial_stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.channels, self.levels, self.stride = channels, levels, spatial_stride
        self.norm = LayerNorm(channels, dtype=dtype)
        self.attn = MultiHeadDotProductAttention(channels, num_heads, dtype)
        self.proj = Dense(channels, channels, use_bias=False, dtype=dtype, spectral=False)

    def forward(self, x):
        b, h, w, cl = x.shape
        s = self.stride
        dom = par_ctx.domain_group()
        if dom is not None and h % s:  # a slab whose pools straddle two slabs
            return par_ctx.on_full(self.forward, x, dom, "col_attn")
        xs = x
        if s > 1:  # flax avg_pool, VALID
            xs = F.avg_pool2d(x.permute(0, 3, 1, 2), s, s).permute(0, 2, 3, 1)
        hs, ws = xs.shape[1], xs.shape[2]
        xt = xs.reshape(b, hs, ws, self.channels, self.levels).transpose(3, 4)
        xt = xt.reshape(b * hs * ws, self.levels, self.channels)
        delta = self.proj(self.attn(self.norm(xt)))
        delta = delta.reshape(b, hs, ws, self.levels, self.channels).transpose(3, 4)
        delta = delta.reshape(b, hs, ws, cl)
        if s > 1:
            delta = bilinear_resize(delta, h, w)
        return x + delta


class SpectralGNNBottleneck(nn.Module):
    """GroupNorm(1) over (H, W, C), pooling of the N nodes onto K virtual
    nodes (`agg_w`), a channel MLP with exact GELU, the scatter back
    (`scatter_w`), plus the residual; in f32 (the reference's f32
    parameters promote the einsums), the MLP in the compute dtype. On a
    latitude slab see the module; `slab_sums` counts the pooled nodes'
    all-reduces."""

    def __init__(self, dim: int, n_nodes: int, num_spectral_nodes: int = 64,
                 mlp_ratio: float = 2.0, dtype=torch.float32):
        super().__init__()
        n, k = n_nodes, num_spectral_nodes
        self.n_nodes = n
        self.norm_scale = _param(dim, fill=1.0)
        self.norm_bias = _param(dim)
        self.agg_w = _param(k, n)
        self.scatter_w = _param(n, k)
        self.seed_init = {"agg_w": ("normal", n ** -0.5), "scatter_w": ("normal", k ** -0.5)}
        hdim = max(1, int(dim * mlp_ratio))
        self.mlp_fc1 = Dense(dim, hdim, dtype=dtype, spectral=False)
        self.mlp_fc2 = Dense(hdim, dim, dtype=dtype, spectral=False)
        self.slab_sums = 0

    def forward(self, x):
        b, h, w, c = x.shape
        dom = par_ctx.domain_group()
        rows = (h,) if dom is None else par_ctx.slab_rows(h)
        if sum(rows) * w != self.n_nodes:
            raise ValueError(f"the bottleneck was built for {self.n_nodes} nodes, got "
                             f"{sum(rows)}x{w}")
        xf = x.float().reshape(b, -1)
        if dom is None:
            mean = xf.mean(-1, keepdim=True)
            var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        else:  # GroupNorm(1)'s moments over every domain rank's rows
            from credit_torch.parallel.halo import distributed_group_norm_moments

            mean, var = distributed_group_norm_moments(x, 1, dom[0])
        xn = ((xf - mean) * torch.rsqrt(var + 1e-5)).reshape(b, h, w, c)
        xn = xn * self.norm_scale.float() + self.norm_bias.float()
        agg, scatter = self.agg_w, self.scatter_w
        if dom is not None:  # this rank's nodes: rows of the row-major node index
            first = sum(rows[:dom[2]]) * w
            agg, scatter = agg[:, first:first + h * w], scatter[first:first + h * w]
        s = torch.einsum("bnc,kn->bkc", xn.reshape(b, h * w, c), agg.float())
        if dom is not None:
            from credit_torch.parallel.halo import all_reduce_sum

            # the pooled nodes summed over the ranks; the backward sums the
            # ranks' shares of ds, which every rank's xn needs whole. The MLP
            # then runs on the whole sum on every rank, but each rank's
            # gradient of it comes from its own nodes' scatter only: a share,
            # so gradient_divisors keeps divisor 1 for mlp_fc1 / mlp_fc2
            s = all_reduce_sum(s, dom[0], reduce_grad=True)
            self.slab_sums += 1
        s = self.mlp_fc2(F.gelu(self.mlp_fc1(s)))
        delta = torch.einsum("bkc,nk->bnc", s.float(), scatter.float())
        delta = delta.reshape(b, h, w, c)
        return delta + x


def embed_size(size: int, kernel_sizes: Sequence[Sequence[int]], strides: Sequence[int]) -> int:
    """A grid dim after the four cross-embeds: each conv's output,
    (n + 2 ((k - s) // 2) - k) // s + 1, is the same for every kernel of a
    stage."""
    for ks, s in zip(kernel_sizes, strides):
        k = min(ks)
        size = (size + 2 * ((k - s) // 2) - k) // s + 1
    return size


@registry.register("model", "nextgen_wxformer")
class NextGenWXFormer(BaseModel):
    """Constructor arguments mirror the reference config's model keys;
    spectral norm (folded, or u/v state with `sn_state=True`) is on the
    cross-embeds, transformers, UpBlockPS and the head, as in the
    reference."""

    ROUTING_KEYS = ("remat", "scan_blocks", "pallas_conv", "ff_fusion", "use_pallas_attention")

    def __init__(self, image_height: int = 640, image_width: int = 1280, frames: int = 2,
                 output_frames: int = 1, channels: int = 4, surface_channels: int = 7,
                 input_only_channels: int = 3, output_only_channels: int = 0, levels: int = 15,
                 dim: Sequence[int] = (64, 128, 256, 512), depth: Sequence[int] = (2, 2, 8, 2),
                 dim_head: int = 32, global_window_size: Sequence[int] = (5, 5, 2, 1),
                 local_window_size: Any = 10,
                 cross_embed_kernel_sizes: Sequence = ((4, 8, 16, 32), (2, 4), (2, 4), (2, 4)),
                 cross_embed_strides: Sequence[int] = (4, 2, 2, 2), col_attn_heads: int = 4,
                 col_attn_stride: int = 1, num_spectral_nodes: int = 64,
                 use_spectral_norm: bool = True, compute_dtype: Any = torch.float32,
                 sn_state: bool = False, **routing):
        super().__init__()
        self._check_routing(routing)
        if isinstance(compute_dtype, str):
            compute_dtype = DTYPES[compute_dtype]
        self.image_height, self.image_width = image_height, image_width
        self.use_spectral_norm = use_spectral_norm
        self.compute_dtype = dt = compute_dtype
        sn = bool(use_spectral_norm and sn_state)
        self.atmos = channels * levels
        self.base_input_channels = self.atmos + surface_channels + input_only_channels
        self.base_output_channels = self.atmos + surface_channels + output_only_channels
        dims = _tup(dim)
        depths = _tup(depth)
        gws, lws = _tup(global_window_size), _tup(local_window_size)
        self.strides = strides = _tup(cross_embed_strides)
        ksizes = tuple(tuple(k) for k in cross_embed_kernel_sizes)
        self.level_embedding = LevelEmbedding(self.atmos)
        self.col_attn = ColumnAttention(channels, levels, col_attn_heads, col_attn_stride, dt)
        c = self.base_input_channels * frames
        for i in range(4):
            self.add_module(f"cel{i}", CrossEmbedLayer(c, dims[i], ksizes[i], strides[i], dt, sn))
            self.add_module(f"transformer{i}",
                            Transformer(dims[i], depths[i], lws[i], gws[i], dim_head, dt, sn))
            c = dims[i]
        last, ng = dims[-1], dims[0]
        n_nodes = (embed_size(image_height, ksizes, strides)
                   * embed_size(image_width, ksizes, strides))
        self.spectral_bottleneck = SpectralGNNBottleneck(last, n_nodes, num_spectral_nodes,
                                                         dtype=dt)
        c = last
        for k, enc in ((1, 2), (2, 1), (3, 0)):
            self.add_module(f"up_block{k}", UpBlockPS(c, last // 2 ** k, ng, dtype=dt, sn=sn))
            c = last // 2 ** k + dims[enc]
        self.up4_ps_conv = Conv(c, self.base_output_channels * 4, 3, 1, 1, dt, sn,
                                kernel_init=("icnr", 2))

    # the forward splits latitude over the domain ranks (_forward_slabs)
    lat_sharded = True

    def _residual(self, x: torch.Tensor) -> torch.Tensor:
        """The persistence residual: the last frame's first out_c channels,
        zero-padded for output-only diagnostics."""
        out_c = self.base_output_channels
        n_avail = min(out_c, x.shape[-1])
        return F.pad(x[:, -1, ..., :n_avail], (0, out_c - n_avail))

    def _frames(self, x: torch.Tensor) -> torch.Tensor:
        """Per frame the level embedding and column attention of the
        atmospheric channels, the rest as they are, frames time-major."""
        frames = []
        for ti in range(x.shape[1]):
            frames.append(self.col_attn(self.level_embedding(x[:, ti, ..., :self.atmos])))
            frames.append(x[:, ti, ..., self.atmos:])
        return torch.cat(frames, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if par_ctx.halo_mesh_active():
            return self._forward_slabs(x)
        x_res = self._residual(x)
        h = self._frames(x)
        encodings = []
        for i in range(4):
            h = getattr(self, f"transformer{i}")(getattr(self, f"cel{i}")(h))
            encodings.append(h)
        h = self.spectral_bottleneck(h)
        for k, enc in ((1, encodings[2]), (2, encodings[1]), (3, encodings[0])):
            h = getattr(self, f"up_block{k}")(h)
            h = bilinear_resize(h, enc.shape[1], enc.shape[2])
            h = torch.cat([h, enc.to(h.dtype)], dim=-1)
        h = pixel_shuffle(self.up4_ps_conv(h), 2)
        h = bilinear_resize(h, self.image_height, self.image_width)
        return channels_to_frames(h + x_res, 1)

    def _forward_slabs(self, x: torch.Tensor) -> torch.Tensor:
        """forward with latitude split over the mesh's domain ranks (see
        the module); the same function of x on every domain rank."""
        from credit_torch.parallel.halo import gather_lat, scale_grad, shard_lat

        group, n, r = par_ctx.mesh_domain()
        x_res = self._residual(x)
        sh = x.shape[2] % n == 0

        def run(fn, t, on_slabs):
            with par_ctx.lat_slabs(on_slabs):
                return fn(t)

        h = run(self._frames, shard_lat(x, n, r) if sh else x, sh)
        encodings = []
        for i in range(4):
            rows = h.shape[1] * n if sh else h.shape[1]
            if sh and (rows % self.strides[i] or (rows // self.strides[i]) % n):
                h, sh = par_ctx.gather_whole(h, group, "stage"), False
            h = run(getattr(self, f"cel{i}"), h, sh)
            h = run(getattr(self, f"transformer{i}"), h, sh)
            encodings.append((h, sh))
        h = run(self.spectral_bottleneck, h, sh)
        for k, enc in ((1, 2), (2, 1), (3, 0)):
            h = run(getattr(self, f"up_block{k}"), h, sh)
            e, e_sh = encodings[enc]
            if e_sh and not sh:  # back to slabs at the first skip that is one
                h = bilinear_resize(h, e.shape[1] * n, e.shape[2])
                h, sh = shard_lat(h, n, r), True
            else:  # the stages past a whole one are whole: both slabs or both whole
                h = run(lambda t: bilinear_resize(t, e.shape[1], e.shape[2]), h, sh)
            h = torch.cat([h, e.to(h.dtype)], dim=-1)
        h = run(lambda t: pixel_shuffle(self.up4_ps_conv(t), 2), h, sh)
        # every domain rank computes the same from here on (as the CrossFormer's)
        h = gather_lat(h, group, same_downstream=True) if sh else scale_grad(h, 1.0 / n)
        h = bilinear_resize(h, self.image_height, self.image_width)
        return channels_to_frames(h + x_res, 1)

"""Building blocks of the CrossFormer and FuXi: port of
credit_tpu/models/layers.py.

Parameter names mirror the flax tree (`kernel` HWIO or (in, out), `bias`,
`scale`), so a state_dict key is the flax path joined with dots. Activations
are channels-last. Each module has a compute `dtype`: weights are cast to it
at use (a no-op when the model was cast once), norm statistics stay f32 as
in the reference.

Spectral norm comes in two forms. Folded (inference): it was divided into
the kernels before they reached these modules (`convert_jax.init_folded`,
`from_jax_variables`), and the layers carry plain kernels. With SN state
(`sn=True`, training): every kernel-bearing layer also holds `u` (O,) and
`v` (rest,) buffers, named like the flax `spectral` collection's leaves, and
computes with `sn_kernel()` = kernel / sigma; in `train()` mode one power
iteration refreshes u and v per forward (torch spectral_norm semantics, as
credit_tpu's SNMixin), except inside `freeze_sn_updates()`. A layer's
`spectral` says whether the reference normalises its kernel at all when the
model's `use_spectral_norm` is on: every kernel of the CrossFormer, only the
SN convs of FuXi.

Seeded initialisation (`convert_jax`) reads each layer's `kernel_init`:
he_uniform unless the reference's layer says otherwise (the ICNR kernels
of `UpBlockPS` and the sub-pixel heads, its xavier-normal `sharp` conv,
camulator's zero `sharp` skip), and a module's `seed_init` for other
randomly initialised parameters.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from credit_torch.models.spectral_utils import sn_kernel
from credit_torch.ops import conv as conv_ops
from credit_torch.parallel import context as par_ctx
from credit_torch.ops import window_attention as wa
from credit_torch.ops.cuda_attention import fused_window_attention_diff
from credit_torch.ops.cuda_ff import ff_over_tp, fused_ff_diff
from credit_torch.ops.upsample import pixel_shuffle


_SN_FREEZE = contextvars.ContextVar("credit_torch_sn_freeze", default=False)


@contextlib.contextmanager
def freeze_sn_updates(enable: bool = True):
    """Inside this context, train-mode forwards skip the per-forward u/v
    power iteration and divide by the differentiable sigma from the stored
    vectors (credit_tpu's freeze_sn_updates; trainer.sn_external updates
    u/v before the step with `spectral_utils.power_iter_model_`)."""
    tok = _SN_FREEZE.set(enable)
    try:
        yield
    finally:
        _SN_FREEZE.reset(tok)


def _param(*shape, fill: float = 0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=torch.float32))


class _Kernel(nn.Module):
    """A layer with a `kernel` (..., O) and, with SN state, its u and v."""

    spectral = True  # the reference's SN layers (SNConv, SNDense, ...)
    # the seeded initialisation of `kernel` (convert_jax): ("he_uniform",),
    # ("icnr", scale), ("xavier_normal",) or ("zeros",)
    kernel_init = ("he_uniform",)

    def _init_kernel(self, shape, sn: bool):
        self.kernel = _param(*shape)
        self.register_buffer("u", torch.zeros(shape[-1]) if sn else None)
        self.register_buffer("v", torch.zeros(math.prod(shape[:-1])) if sn else None)

    def sn_kernel(self) -> torch.Tensor:
        """The kernel to compute with: kernel / sigma with SN state (one
        power iteration first in train mode, unless `freeze_sn_updates` is
        on), the kernel itself without."""
        if self.u is None:
            return self.kernel
        return sn_kernel(self.kernel, self.u, self.v,
                         update=self.training and not _SN_FREEZE.get())


class Dense(_Kernel):
    """x @ kernel (in, out) + bias, as one 2-D GEMM in the compute dtype."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.float32, sn: bool = False, spectral: bool = True):
        super().__init__()
        self.dtype, self.spectral = dtype, spectral
        self._init_kernel((in_features, features), sn)
        self.bias = _param(features) if use_bias else None

    def forward(self, x):
        x = x.to(self.dtype)
        y = x.reshape(-1, x.shape[-1]) @ self.sn_kernel().to(self.dtype)
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Conv(_Kernel):
    """2-D conv, torch-style symmetric padding, HWIO kernel. `spectral`
    False is a plain conv of the reference (no SN whatever the model's
    `use_spectral_norm`); `kernel_init` overrides the seeded initialisation."""

    def __init__(self, in_ch: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32, sn: bool = False,
                 spectral: bool = True, kernel_init=None):
        super().__init__()
        self.dtype, self.stride, self.padding = dtype, stride, padding
        self.spectral = spectral
        if kernel_init is not None:
            self.kernel_init = kernel_init
        self._init_kernel((kernel_size, kernel_size, in_ch, features), sn)
        self.bias = _param(features)

    def forward(self, x):
        return conv_ops.conv2d(x.to(self.dtype), self.sn_kernel().to(self.dtype), self.bias,
                               self.stride, self.padding)


class ConvTranspose(_Kernel):
    """Transposed 2-D conv with torch ConvTranspose2d output semantics;
    kernel stored (kh, kw, in, out)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int, stride: int = 2,
                 padding: int = 0, dtype=torch.float32, sn: bool = False):
        super().__init__()
        self.dtype, self.stride, self.padding = dtype, stride, padding
        self._init_kernel((kernel_size, kernel_size, in_ch, features), sn)
        self.bias = _param(features)

    def forward(self, x):
        return conv_ops.conv_transpose2d(x.to(self.dtype), self.sn_kernel().to(self.dtype),
                                         self.bias, self.stride, self.padding)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis, biased variance, eps 1e-5,
    statistics in f32."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = _param(dim, fill=1.0)
        self.bias = _param(dim)

    def forward(self, x):
        # F.layer_norm keeps f32 statistics and applies scale and bias in f32
        # before one rounding to its input's dtype, as the reference does;
        # parameters of another dtype than x take the f32 route
        if self.scale.dtype != x.dtype:
            x = x.float()
        return F.layer_norm(x, (x.shape[-1],), self.scale.to(x.dtype), self.bias.to(x.dtype),
                            self.eps).to(self.dtype)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm (eps 1e-5): variance as E[x^2] - E[x]^2, in f32."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = _param(dim, fill=1.0)
        self.bias = _param(dim)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(self.dtype)


class GroupNorm(nn.Module):
    """GroupNorm with torch defaults (eps 1e-5), channels-last, f32 stats."""

    def __init__(self, num_groups: int, dim: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.scale = _param(dim, fill=1.0)
        self.bias = _param(dim)

    def forward(self, x):
        shape = x.shape
        c = shape[-1]
        xf = x.float().reshape(shape[0], -1, self.num_groups, c // self.num_groups)
        dom = par_ctx.domain_group()
        if dom is not None:  # a latitude slab: the moments over every domain rank's rows
            from credit_torch.parallel.halo import distributed_group_norm_moments

            mean, var = distributed_group_norm_moments(x, self.num_groups, dom[0])
            mean, var = mean[:, None, :, None], var[:, None, :, None]
        else:
            mean = xf.mean(dim=(1, 3), keepdim=True)
            var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(shape)
        return (y * self.scale.float() + self.bias.float()).to(self.dtype)


class DynamicPositionBias(nn.Module):
    """MLP on relative (dy, dx) offsets -> one scalar bias per offset: three
    Linear + LayerNorm + ReLU blocks, then Linear -> 1. Always f32."""

    def __init__(self, dim: int, sn: bool = False):
        super().__init__()
        f32 = torch.float32
        for i in range(3):
            self.add_module(f"fc{i}", Dense(2 if i == 0 else dim, dim, dtype=f32, sn=sn))
            self.add_module(f"ln{i}", LayerNorm(dim, dtype=f32))
        self.fc_out = Dense(dim, 1, dtype=f32, sn=sn)

    def forward(self, rel):
        x = rel.float()
        for i in range(3):
            x = F.relu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(x)))
        return self.fc_out(x)[..., 0]


class WindowAttention(nn.Module):
    """Short (windowed) or long (dilated-grid) multi-head attention: pre-norm,
    one fused qkv GEMM, windowed attention (kernel 3, differentiable) with
    the dynamic position bias, output projection. The residual is added by
    the caller.

    The (T, T) bias depends only on parameters; inside
    `position_bias_cache(model)` it is computed once and reused by later
    forwards, as the reference's dpb_cache collection does in a rollout."""

    def __init__(self, dim: int, attn_type: str, window_size: int, dim_head: int = 32,
                 dtype=torch.float32, sn: bool = False):
        super().__init__()
        self.dim, self.attn_type, self.window_size = dim, attn_type, window_size
        self.heads = dim // dim_head
        self.inner = self.heads * dim_head
        self.dtype = dtype
        self.norm = ChannelLayerNorm(dim, dtype=dtype)
        self.to_qkv = Dense(dim, self.inner * 3, use_bias=False, dtype=dtype, sn=sn)
        self.dpb = DynamicPositionBias(dim // 4, sn=sn)
        self.to_out = Dense(self.inner, dim, dtype=dtype, sn=sn)
        self.register_buffer("rel_grid", torch.from_numpy(wa.relative_position_grid(window_size)),
                             persistent=False)
        self.register_buffer("rel_index", wa.relative_position_index(window_size),
                             persistent=False)
        self.cache_bias = False
        self.bias_cache = None

    def clear_cache(self):
        self.bias_cache = None

    def position_bias(self):
        if self.cache_bias and self.bias_cache is not None:
            return self.bias_cache
        bias = self.dpb(self.rel_grid)[self.rel_index]
        if self.cache_bias:
            self.bias_cache = bias
        return bias

    def forward(self, x):
        dom = par_ctx.domain_group()
        if dom is not None and not (self.attn_type == "short"
                                    and x.shape[1] % self.window_size == 0):
            # a long window spans every slab (and a short one may straddle
            # two): the gather path, attention on the whole field
            return par_ctx.on_full(self._attend, x, dom, f"{self.attn_type}_attn")
        return self._attend(x)

    def _attend(self, x):
        b, h, w, _ = x.shape
        mesh = par_ctx.mesh()
        tp = mesh.shape["tp"] if mesh is not None else 1
        if tp > 1:
            from credit_torch.parallel.halo import copy_to_group

            x = copy_to_group(x, mesh.group("tp"))
        x = self.norm(x)
        xw = wa.window_partition(x, self.window_size, self.attn_type)
        if tp == 1:
            q, k, v = self.to_qkv(xw).split(self.inner, dim=-1)
            out = fused_window_attention_diff(q, k, v, self.position_bias(), self.heads)
            out = self.to_out(out)
        else:
            out = self._attend_tp(xw, mesh, tp)
        return wa.window_unpartition(out, self.window_size, h, w, self.attn_type)

    def _attend_tp(self, xw, mesh, tp: int):
        """Heads split over the tp ranks: this rank's heads' q, k and v
        columns of to_qkv (head-major within each of q, k, v, not
        contiguous columns of [q|k|v]), kernel 3 on heads / tp, this rank's
        rows of to_out, the partial outputs all-reduced (the bias added
        once, by tp rank 0)."""
        from credit_torch.parallel.halo import all_reduce_sum

        if self.heads % tp:
            raise ValueError(f"{self.heads} heads do not split over tensor={tp}")
        t = mesh.coord("tp")
        width = self.inner // tp
        cols = slice(t * width, (t + 1) * width)
        wq, wk, wv = self.to_qkv.sn_kernel().to(self.dtype).split(self.inner, dim=-1)
        kern = torch.cat([wq[:, cols], wk[:, cols], wv[:, cols]], dim=-1)
        xw = xw.to(self.dtype)
        qkv = (xw.reshape(-1, xw.shape[-1]) @ kern).reshape(*xw.shape[:-1], 3 * width)
        q, k, v = qkv.split(width, dim=-1)
        out = fused_window_attention_diff(q, k, v, self.position_bias(), self.heads // tp)
        y = out.reshape(-1, width) @ self.to_out.sn_kernel().to(self.dtype)[cols]
        y = y.reshape(*out.shape[:-1], y.shape[-1])
        if t == 0:
            y = y + self.to_out.bias.to(self.dtype)
        return all_reduce_sum(y, mesh.group("tp"), reduce_grad=False)


@contextlib.contextmanager
def position_bias_cache(model: nn.Module):
    """Within this block every attention module of `model` that depends on
    parameters and shapes alone (`WindowAttention`'s position-bias table;
    `swin.WindowAttentionV2`'s CPB table and shifted-window masks) computes
    it once; the tables are dropped on exit."""
    mods = [m for m in model.modules() if hasattr(m, "cache_bias")]
    for m in mods:
        m.cache_bias = True
        m.clear_cache()
    try:
        yield
    finally:
        for m in mods:
            m.cache_bias = False
            m.clear_cache()


def ff_tp(hidden: int):
    """(group, rank, size) of the tp axis where a FF of `hidden` columns
    splits over it (credit_tpu's param_spec: fc1's columns and fc2's rows
    over tp where the hidden width divides), else None."""
    mesh = par_ctx.mesh()
    tp = mesh.shape["tp"] if mesh is not None else 1
    if tp == 1 or hidden % tp:
        return None
    return mesh.group("tp"), mesh.coord("tp"), tp


class FeedForward(nn.Module):
    """x + fc2(GELU(fc1(LN(x)))), the FF block with its residual, as one
    call of the fused kernel (kernel 1; kernel 4 in the backward) on the
    spectrally normalized kernels. Under a mesh with tp > 1 (`ff_tp`) each
    rank runs kernels 1 and 4 on its slice of the hidden layer
    (`cuda_ff.ff_over_tp`); sigma is the whole kernel's, sliced after."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32, sn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.norm = ChannelLayerNorm(dim, dtype=dtype)
        self.fc1 = Dense(dim, dim * mult, dtype=dtype, sn=sn)
        self.fc2 = Dense(dim * mult, dim, dtype=dtype, sn=sn)

    def forward(self, x):
        args = (x.to(self.dtype), self.norm.scale, self.norm.bias, self.fc1.sn_kernel(),
                self.fc1.bias, self.fc2.sn_kernel(), self.fc2.bias)
        tp = ff_tp(self.fc1.kernel.shape[1])
        if tp is not None:
            return ff_over_tp(*args, False, *tp)
        return fused_ff_diff(*args)


class Transformer(nn.Module):
    """depth x (short-attn, FF, long-attn, FF) with residuals."""

    def __init__(self, dim: int, depth: int, local_window_size: int, global_window_size: int,
                 dim_head: int = 32, dtype=torch.float32, sn: bool = False):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"short_attn{i}",
                            WindowAttention(dim, "short", local_window_size, dim_head, dtype, sn))
            self.add_module(f"short_ff{i}", FeedForward(dim, dtype=dtype, sn=sn))
            self.add_module(f"long_attn{i}",
                            WindowAttention(dim, "long", global_window_size, dim_head, dtype, sn))
            self.add_module(f"long_ff{i}", FeedForward(dim, dtype=dtype, sn=sn))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"short_attn{i}")(x) + x
            x = getattr(self, f"short_ff{i}")(x)
            x = getattr(self, f"long_attn{i}")(x) + x
            x = getattr(self, f"long_ff{i}")(x)
        return x


class CrossEmbedLayer(nn.Module):
    """Multi-kernel stride-2 conv patch embed; the per-scale outputs are
    concatenated along channels (padding (k - 2) // 2 keeps H/2 x W/2).

    Two fused forms, as in the reference:
      quadrant: the largest kernel kmax is split into (kmax/kb)^2 kb x kb
        blocks that become extra output groups of ONE conv with every kernel
        padded to the second-largest kb; the kmax output is the sum of those
        groups read at offsets a*kb/2 (the flagship's stage 0: 4/8/16/32);
      padded: every kernel zero-padded to kmax and concatenated along output
        channels (stages 1-3: 2/4).
    Anything else runs one conv per scale.
    """

    def __init__(self, dim_in: int, dim_out: int, kernel_sizes: Sequence[int], stride: int = 2,
                 dtype=torch.float32, sn: bool = False):
        super().__init__()
        self.ks = sorted(int(k) for k in kernel_sizes)
        n = len(self.ks)
        scales = [dim_out // (2 ** i) for i in range(1, n)]
        self.dim_scales = [*scales, dim_out - sum(scales)]
        self.stride, self.dtype = stride, dtype
        for i, (k, d) in enumerate(zip(self.ks, self.dim_scales)):
            self.add_module(f"conv{i}", Conv(dim_in, d, k, stride, (k - stride) // 2, dtype, sn))
        kmax = self.ks[-1]
        kb = self.ks[-2] if n > 1 else kmax
        even2 = stride == 2 and all(k % 2 == 0 for k in self.ks) and n > 1
        self.quadrant = (even2 and kmax >= 2 * kb and kmax % kb == 0
                         and ((kmax - kb) // 2) % 2 == 0 and kb >= 8)
        self.padded = even2 and not self.quadrant

    def _convs(self):
        return [getattr(self, f"conv{i}") for i in range(len(self.ks))]

    def forward(self, x):
        x = x.to(self.dtype)
        convs = self._convs()
        ks = self.ks
        kmax = ks[-1]
        if self.quadrant:
            kb = ks[-2]
            q = kmax // kb
            kernels, biases = [], []
            for cv, k in zip(convs[:-1], ks[:-1]):
                p = (kb - k) // 2
                kernels.append(F.pad(cv.sn_kernel(), (0, 0, 0, 0, p, p, p, p)))
                biases.append(cv.bias)
            big = convs[-1]
            kbig = big.sn_kernel()
            for a in range(q):
                for bq in range(q):
                    kernels.append(kbig[a * kb:(a + 1) * kb, bq * kb:(bq + 1) * kb])
                    biases.append(torch.zeros_like(big.bias))
            kmerged = torch.cat(kernels, dim=-1).to(self.dtype)
            dom = par_ctx.domain_group()
            if dom is None:
                out = conv_ops.conv2d(x, kmerged, torch.cat(biases), stride=2,
                                      padding=(kmax - 2) // 2)
            elif x.shape[1] % 2 == 0 and x.shape[1] >= (kmax - 2) // 2:
                # a slab: the local s2d gives this rank's rows and the
                # quadrants' overlap, which the offsets below cut
                out = conv_ops.s2d_halo(x, kmerged, torch.cat(biases),
                                        ((kmax - 2) // 2,) * 2, dom)
            else:
                return par_ctx.on_full(self.forward, x, dom, "cross_embed")
            e = (kmax - kb) // 4
            h2 = out.shape[1] - 2 * e
            w2 = out.shape[2] - 2 * e
            d_small = sum(self.dim_scales[:-1])
            dmax = self.dim_scales[-1]
            small = out[:, e:e + h2, e:e + w2, :d_small]
            rec = big.bias.to(out.dtype)
            idx = 0
            for a in range(q):
                for bq in range(q):
                    c0 = d_small + idx * dmax
                    rec = rec + out[:, a * kb // 2:a * kb // 2 + h2,
                                    bq * kb // 2:bq * kb // 2 + w2, c0:c0 + dmax]
                    idx += 1
            return torch.cat([small, rec], dim=-1)
        if self.padded:
            kernels = []
            for cv, k in zip(convs, ks):
                p = (kmax - k) // 2
                kernels.append(F.pad(cv.sn_kernel(), (0, 0, 0, 0, p, p, p, p)))
            return conv_ops.conv2d(x, torch.cat(kernels, dim=-1).to(self.dtype),
                                   torch.cat([cv.bias for cv in convs]), stride=2,
                                   padding=(kmax - 2) // 2)
        return torch.cat([cv(x) for cv in convs], dim=-1)


class UpBlock(nn.Module):
    """ConvTranspose(2, 2) upsample + residual stack of 3x3 conv, GroupNorm,
    SiLU."""

    def __init__(self, in_ch: int, out_chans: int, num_groups: int, num_residuals: int = 2,
                 dtype=torch.float32, sn: bool = False):
        super().__init__()
        self.num_residuals = num_residuals
        self.up = ConvTranspose(in_ch, out_chans, 2, 2, 0, dtype, sn)
        for i in range(num_residuals):
            self.add_module(f"res_conv{i}", Conv(out_chans, out_chans, 3, 1, 1, dtype, sn))
            self.add_module(f"res_gn{i}", GroupNorm(num_groups, out_chans, dtype=dtype))

    def forward(self, x):
        x = self.up(x)
        shortcut = x
        for i in range(self.num_residuals):
            x = getattr(self, f"res_conv{i}")(x)
            x = getattr(self, f"res_gn{i}")(x)
            x = F.silu(x)
        return x + shortcut


class UpBlockPS(nn.Module):
    """Sub-pixel upsample: a 3x3 conv to out * scale^2 channels (ICNR
    kernel), pixel shuffle, a 3x3 `sharp` conv added as a residual, then
    the residual stack of 3x3 conv, GroupNorm, SiLU."""

    def __init__(self, in_ch: int, out_chans: int, num_groups: int, scale: int = 2,
                 num_residuals: int = 2, dtype=torch.float32, sn: bool = False):
        super().__init__()
        self.scale, self.num_residuals = scale, num_residuals
        self.ps_conv = Conv(in_ch, out_chans * scale * scale, 3, 1, 1, dtype, sn,
                            kernel_init=("icnr", scale))
        self.sharp = Conv(out_chans, out_chans, 3, 1, 1, dtype, sn,
                          kernel_init=("xavier_normal",))
        for i in range(num_residuals):
            self.add_module(f"res_conv{i}", Conv(out_chans, out_chans, 3, 1, 1, dtype, sn))
            self.add_module(f"res_gn{i}", GroupNorm(num_groups, out_chans, dtype=dtype))

    def forward(self, x):
        x = pixel_shuffle(self.ps_conv(x), self.scale)
        x = x + self.sharp(x)
        shortcut = x
        for i in range(self.num_residuals):
            x = getattr(self, f"res_conv{i}")(x)
            x = getattr(self, f"res_gn{i}")(x)
            x = F.silu(x)
        return x + shortcut


class CubeEmbedding(_Kernel):
    """Conv3d patch embed over (time, lat, lon), then LayerNorm over the
    embed dim, without spectral norm (credit_tpu CubeEmbedding). Input
    (B, T, H, W, C) -> (B, T', H', W', embed_dim)."""

    spectral = False

    def __init__(self, in_ch: int, embed_dim: int, patch_size: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        self.dtype, self.patch_size = dtype, tuple(patch_size)
        self._init_kernel((*self.patch_size, in_ch, embed_dim), False)
        self.bias = _param(embed_dim)
        self.norm = LayerNorm(embed_dim, dtype=dtype)

    def forward(self, x):
        y = conv_ops.conv3d(x.to(self.dtype), self.kernel.to(self.dtype), self.bias,
                            stride=self.patch_size)
        return self.norm(y)

"""Fused feed-forward with its residual (kernel 1), its backward (kernel 4)
and the two joined as an autograd Function, in both forms:

    pre-norm (CrossFormer):  x + fc2(GELU(fc1(LN(x))))
    post-norm (SwinV2/FuXi): x + LN(fc2(GELU(fc1(x))))

The port of credit_tpu/ops/pallas_ff.py `fused_ff`, `fused_ff_bwd` and
`fused_ff_diff`. `fused_ff` and `fused_ff_bwd` launch the hand-written CUDA
kernels (`csrc/fused_ff.cu`, `csrc/fused_ff_bwd.cu`) for CUDA tensors and run
`fused_ff_plain` / `fused_ff_bwd_plain` for CPU tensors. As in the TPU
wrapper, the LN parameters and biases are rounded to x's dtype first; LN
statistics and every product accumulate in f32; LN(x) and GELU's output are
cast to x's dtype before the next product; post-norm takes the LN of fc2's
f32 output (b2 included) before its one cast; the residual is added in x's
dtype. The backward keeps the rounding points of the TPU kernel
(pallas_ff.py:239-294): y = LN(x) (pre-norm) or x, a = GELU(h1), the
cotangent of fc2's output and dh1 are in x's dtype where they enter a
product, while the LN statistics, Phi(h1), the pdf and every sum stay f32.

Every width runs on the card; `ff_plan` picks the route per shape. bf16
widths past 256 and widths that are not multiples of 8 run the split route
(`credit_fused_ff_split`: LN rows, then fc1 and fc2 as TMA + wgmma GEMMs
with the biases, GELU and residual in their epilogues, the hidden
activations in device memory once, in bf16); narrower bf16 widths run the
fused wgmma kernel (the 4C hidden layer kept in registers, from fc1's
accumulators to fc2's A operand), f32 widths up to 1024 the fused FMA
kernel; wider or ragged f32 widths run the forward in passes
(`credit_fused_ff_passes`, in `csrc/fused_ff_bwd.cu`), and the backward's
passes take any C: in bf16 on the same wgmma mainloop as the split route,
with the tiles and splits `ffb_plan` picks, in f32 on FMA. Where C or the
hidden width is not a multiple of 8 the wrappers zero-pad them (a copy in,
the result cut back); the kernels take every LN statistic over the true C.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from credit_torch import _build
from credit_torch.ops.cuda_conv import BN_CHOICES, HBM_BYTES_PER_S, SM_FLOPS, SMS, wgmma_bn

EPS = 1e-5
MAX_C = 1024  # widest f32 channel count the fused FMA kernel's register plan takes
# widest bf16 width the fused wgmma kernel takes (its tiles padded to 64, 128
# or 256 columns), and past which the split route runs: on one H100 80GB HBM3
# at 700 W, in turns with the split route, 0.274-0.277 ms against 0.405-0.413
# at C = 256 and 72,000 rows, 0.326-0.348 against 0.721-0.731 at C = 128 and
# 288,000 rows (PERF.md)
FUSED_MAX_C = 256
HIDDEN_CHUNK = 64  # hidden columns a chunk of the fused wgmma kernel
SQRT1_2 = 0.7071067811865476
INV_SQRT_2PI = 0.3989422804014327
ROW_TILE = 128  # rows a product tile (`csrc/fused_ff_bwd.cu` ROW_TILE)
LN_ROWS = 64  # rows a block of the LN backward (LN_ROWS), 16 where rows are few
K_STEP = 64  # K values a mainloop step (`csrc/tma_gemm.cuh` KS)


def _stats(v: torch.Tensor):
    """(v - mean) * rstd and rstd over the last axis, f32: the mean, then the
    mean of squared deviations, as the TPU kernel takes them."""
    mean = v.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((v - mean) ** 2).mean(-1, keepdim=True) + EPS)
    return (v - mean) * rstd, rstd


def _ln(v: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _stats(v)[0] * g + b


def fused_ff_plain(x, g, b, w1, b1, w2, b2, post_norm: bool = False) -> torch.Tensor:
    """The same function in plain PyTorch, for x (..., C): the tp pieces'
    plain versions on the whole hidden layer (`ff_partial_plain`, then
    `ff_finish_plain`)."""
    return ff_finish_plain(x, ff_partial_plain(x, g, b, w1, b1, w2, post_norm), g, b, b2,
                           post_norm)


def fused_ff_split_plain(x, g, b, w1, b1, w2, b2, post_norm: bool = False) -> torch.Tensor:
    """The split route's passes in plain PyTorch, on its operands
    zero-padded to multiples of 8: y = LN(x) over the true C in x's dtype
    (pre-norm), h = GELU(y w1 + b1) in x's dtype, then pre-norm x + (h w2 +
    b2) in x's dtype, or post-norm z = h w2 in f32 and x + LN(z + b2) over
    the true C. The same function as `fused_ff_plain`, at the kernels'
    padding and rounding points."""
    dt = x.dtype
    c, hidden = x.shape[-1], w1.shape[1]
    x2 = x.reshape(-1, c)
    ld = _up8(c)
    xp, (gp, bp, w1p, b1p, w2p, b2p) = _padded(x2, [t.to(dt) for t in (g, b, w1, b1, w2, b2)],
                                               ld, _up8(hidden))
    gf, bf, b2f = gp[:c].float(), bp[:c].float(), b2p[:c].float()
    y = xp if post_norm else _pad_to(_ln(x2.float(), gf, bf).to(dt), 1, ld)
    h = F.gelu(y.float() @ w1p.float() + b1p.float()).to(dt)
    z = (h.float() @ w2p.float())[:, :c]
    v = _ln(z + b2f, gf, bf) if post_norm else z + b2f
    return (x2 + v.to(dt)).reshape(x.shape)


def fused_width(c: int) -> bool:
    """True when a fused kernel (`csrc/fused_ff.cu`) takes width c in f32:
    C % 8 == 0 and C <= MAX_C (bf16: also C <= FUSED_MAX_C). Every other
    width runs a route with the hidden activations in device memory
    (`ff_plan`) on rows zero-padded to a multiple of 8."""
    return c % 8 == 0 and c <= MAX_C


def _fused_takes(c: int, dtype: torch.dtype) -> bool:
    return fused_width(c) and (dtype != torch.bfloat16 or c <= FUSED_MAX_C)


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra == 0:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, extra]
    return F.pad(t, pad)


def _aligned(ts):
    """Each tensor contiguous with a 16-byte aligned base (the kernels copy
    rows in 16-byte vectors)."""
    ts = [t.contiguous() for t in ts]
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def _padded_params(prm, ld: int, hpad: int):
    """(g, b, w1, b1, w2, b2) zero-padded to width ld and hidden width hpad:
    zeros add nothing to a product, GELU(0) = 0, and the kernels keep the
    padded columns out of every LN statistic."""
    g, b, w1, b1, w2, b2 = prm
    return [_pad_to(g, 0, ld), _pad_to(b, 0, ld), _pad_to(_pad_to(w1, 0, ld), 1, hpad),
            _pad_to(b1, 0, hpad), _pad_to(_pad_to(w2, 0, hpad), 1, ld), _pad_to(b2, 0, ld)]


def _padded(x2, prm, ld: int, hpad: int):
    """x (M, C) and the parameters zero-padded to width ld and hidden width
    hpad (`_padded_params`)."""
    return _pad_to(x2, 1, ld), _padded_params(prm, ld, hpad)


@dataclass(frozen=True)
class FFPlan:
    """How one `fused_ff` call runs: the route ("fused", "split" or
    "passes"), the width `ld` and hidden width `hidden` the kernels see
    (zero-padded; the bf16 fused kernel reads C wide rows, zero-filled to
    `ld` in shared memory); that kernel's hidden chunk, rows a tile and
    persistent blocks (`chunk`, `rows`, `grid`; 0 elsewhere); the split
    route's output columns a block of fc2 (`bn2`; fc1's tiles are fixed,
    `csrc/fused_ff.cu`); and the shapes of the workspace the wrapper
    allocates: the split route's y = LN(x) (pre-norm), hidden activations h
    and f32 z = fc2's output (post-norm); None where a route needs none."""

    route: str
    ld: int
    hidden: int
    chunk: int = 0
    rows: int = 0
    grid: int = 0
    bn2: int = 0
    y: tuple | None = None
    h: tuple | None = None
    z: tuple | None = None


def _fused_plan(m: int, c: int, hidden: int, sms: int) -> FFPlan:
    """The fused bf16 kernel's: the width it pads each tile to (64, 128 or
    256, one wgmma width each, by TMA's zero fill), the hidden width padded
    to a multiple of 8 for TMA's 16-byte strides (the kernel walks it in
    chunks of 64, zero-filled past it), tiles of 64 rows a consumer
    warpgroup (three up to 128 columns, two at 256), one persistent block
    an SM (shared memory holds one) or one a row tile where the tiles are
    fewer."""
    cpad = 64
    while cpad < c:
        cpad *= 2
    rows = 64 * (3 if cpad <= 128 else 2)  # 64 a consumer warpgroup (`warpgroups`)
    return FFPlan("fused", cpad, _up8(hidden), chunk=HIDDEN_CHUNK, rows=rows,
                  grid=min(-(-m // rows), sms))


def _split_plan(m: int, c: int, hidden: int, post_norm: bool, sms: int) -> FFPlan:
    """The split route's: ld, hidden padded to multiples of 8, fc2's tiles by
    `cuda_conv.wgmma_bn` (fc1's are 128 x 128, two blocks an SM: on one H100
    FuXi's C = 1024 FF read 0.644-0.656 ms so, 0.711 at 128 x 256 and one
    block an SM, PERF.md), the workspace shapes."""
    ld, hpad = _up8(c), _up8(hidden)
    return FFPlan("split", ld, hpad, bn2=wgmma_bn(-(-m // 128), ld, sms),
                  y=None if post_norm else (m, ld), h=(m, hpad), z=(m, ld) if post_norm else None)


@functools.lru_cache(maxsize=1024)
def ff_plan(m: int, c: int, hidden: int, dtype: torch.dtype, post_norm: bool,
            sms: int = SMS) -> FFPlan:
    """The route of one call at m rows, width c and hidden width `hidden`.
    bf16: the fused wgmma kernel up to FUSED_MAX_C at multiples of 8, else
    the split route. f32: the fused FMA kernel
    where it takes c (`fused_width`), else the passes (ld, hidden padded to
    multiples of 8)."""
    if dtype == torch.bfloat16:
        if _fused_takes(c, dtype):
            return _fused_plan(m, c, hidden, sms)
        return _split_plan(m, c, hidden, post_norm, sms)
    if fused_width(c):
        return FFPlan("fused", c, hidden)
    return FFPlan("passes", _up8(c), _up8(hidden))


def fused_ff(x, g, b, w1, b1, w2, b2, post_norm: bool = False,
             route: str | None = None) -> torch.Tensor:
    """x (M, C) or (B, H, W, C); g, b, b2 (C,); w1 (C, Hd); b1 (Hd,); w2 (Hd, C).
    post_norm selects the SwinV2 form. Any C and Hd, on the route `ff_plan`
    picks; `route` ("fused" or "split", bf16) overrides it to compare the
    two where both take C (C % 8 == 0, C <= FUSED_MAX_C). A launch adds one
    to `fused_ff.launches` and, on the split route, to
    `fused_ff.split_launches`."""
    if x.device.type == "cpu":
        return fused_ff_plain(x, g, b, w1, b1, w2, b2, post_norm)
    c = x.shape[-1]
    hidden = w1.shape[1]
    x2 = x.contiguous().reshape(-1, c)
    m = x2.shape[0]
    plan_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = ff_plan(m, c, hidden, x.dtype, bool(post_norm), plan_sms)
    if route is not None and route != plan.route:
        if (x.dtype != torch.bfloat16 or route not in ("fused", "split")
                or not _fused_takes(c, x.dtype)):
            raise ValueError(f"fused_ff: no {route} route at C={c} in {x.dtype}")
        plan = (_fused_plan(m, c, hidden, plan_sms) if route == "fused"
                else _split_plan(m, c, hidden, bool(post_norm), plan_sms))
    prm = [t.to(x.dtype) for t in (g, b, w1, b1, w2, b2)]
    p, i = ctypes.c_void_p, ctypes.c_int
    if plan.route == "fused":
        # every operand at width C (TMA zero-fills each tile to plan.ld and
        # clips the stores), the hidden width a multiple of 8; zeros add
        # nothing (GELU(0) = 0), and the LNs divide by the true C
        prm = _padded_params(prm, c, plan.hidden)
        x2, *prm = _aligned([x2] + prm)
        out = torch.empty_like(x2)
        fn = _build.function("credit_fused_ff", [p] * 8 + [i] * 7 + [p])
        err = fn(x2.data_ptr(), *(t.data_ptr() for t in prm), out.data_ptr(),
                 _build.dtype_code(x.dtype), m, c, plan.ld, plan.hidden, int(post_norm),
                 plan.grid, _build.stream_ptr())
        _build.check(err, "credit_fused_ff")
        fused_ff.launches += 1
        return out.reshape(x.shape)
    x2, prm = _padded(x2, prm, plan.ld, plan.hidden)
    x2, *prm = _aligned([x2] + prm)
    out = torch.empty_like(x2)
    if plan.route == "split":
        work = [torch.empty(shape, dtype=torch.float32 if name == "z" else x.dtype,
                            device=x.device) if shape else None
                for name, shape in (("y", plan.y), ("h", plan.h), ("z", plan.z))]
        fn = _build.function("credit_fused_ff_split", [p] * 11 + [i] * 6 + [p])
        err = fn(x2.data_ptr(), *(t.data_ptr() for t in prm), out.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in work), m, c, plan.ld,
                 plan.hidden, int(post_norm), plan.bn2, _build.stream_ptr())
        _build.check(err, "credit_fused_ff_split")
        fused_ff.split_launches += 1
    else:
        nbytes = _build.function("credit_fused_ff_passes_workspace", [i] * 3,
                                 ctypes.c_longlong)(m, plan.ld, plan.hidden)
        work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        fn = _build.function("credit_fused_ff_passes", [p] * 9 + [i] * 5 + [p])
        err = fn(x2.data_ptr(), *(t.data_ptr() for t in prm), out.data_ptr(), work.data_ptr(),
                 m, c, plan.ld, plan.hidden, int(post_norm), _build.stream_ptr())
        _build.check(err, "credit_fused_ff_passes")
    fused_ff.launches += 1
    return out[:, :c].reshape(x.shape)


fused_ff.launches = 0
fused_ff.split_launches = 0


# ------------------------------------------------------------------ backward
def _ln_bwd(d: torch.Tensor, vhat: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    """The input gradient of an LN whose normalised output vhat received d
    (scale applied): rstd (d - mean(d) - vhat mean(d vhat))."""
    return rstd * (d - d.mean(-1, keepdim=True) - vhat * (d * vhat).mean(-1, keepdim=True))


def fused_ff_bwd_plain(x, ct, g, b, w1, b1, w2, b2, post_norm: bool = False):
    """The backward in plain PyTorch: (dx, dg, db, dw1, db1, dw2, db2) with
    dx in x's dtype and the parameter gradients summed over rows in f32."""
    dt = x.dtype
    c = x.shape[-1]
    xf = x.reshape(-1, c).float()
    ctf = ct.reshape(-1, c).to(dt).float()
    g, b, b1, b2 = (t.to(dt).float() for t in (g, b, b1, b2))
    w1, w2 = w1.to(dt).float(), w2.to(dt).float()
    if post_norm:
        y = xf
    else:
        xhat, rstd = _stats(xf)
        y = (xhat * g + b).to(dt).float()
    h1 = y @ w1 + b1
    phi = 0.5 * (1.0 + torch.erf(h1 * SQRT1_2))
    a = (h1 * phi).to(dt).float()
    if post_norm:  # push ct through the output LN first; b2 moves its statistics
        ohat, rstd_o = _stats(a @ w2 + b2)
        dg, db = (ctf * ohat).sum(0), ctf.sum(0)
        do2 = _ln_bwd(ctf * g, ohat, rstd_o)
        db2 = do2.sum(0)
        do2 = do2.to(dt).float()
    else:
        do2 = ctf
        db2 = ctf.sum(0)
    dw2 = a.T @ do2
    da = do2 @ w2.T
    dh1 = da * (phi + h1 * torch.exp(-0.5 * h1 * h1) * INV_SQRT_2PI)
    dh1r = dh1.to(dt).float()
    dw1 = y.T @ dh1r
    dy = dh1r @ w1.T
    if post_norm:
        dx = ctf + dy
    else:
        dg, db = (dy * xhat).sum(0), dy.sum(0)
        dx = ctf + _ln_bwd(dy * g, xhat, rstd)
    return dx.to(dt).reshape(x.shape), dg, db, dw1, dh1.sum(0), dw2, db2


@dataclass(frozen=True)
class FFBPlan:
    """How one bf16 `fused_ff_bwd` call runs on the card
    (`csrc/fused_ff_bwd.cu`, every product on the wgmma mainloop): the m
    rows, width `ld` and hidden width `hidden` the kernels see (zero-padded
    to multiples of 8), which size the workspace; the LN backward's rows a
    block `ln_rows`; the output columns of a 128-row tile of post-norm o2 =
    a w2 (`bn_o2`, 0 in pre-norm form) and of dy = dh1 w1^T (`bn_dy`); the
    weight gradients' `bn_w1` / `bn_w2` and their splits over the rows `s1`
    / `s2` (dw1 is ld x hidden, dw2 hidden x ld). Pass 2 (h1 = y w1 and da
    = g w2^T into two accumulator sets) always runs 128 x 128 tiles."""

    m: int
    ld: int
    hidden: int
    ln_rows: int
    bn_o2: int
    bn_dy: int
    bn_w1: int
    s1: int
    bn_w2: int
    s2: int

    def workspace(self) -> dict:
        """name -> (shape, dtype) of each buffer the kernels need, in the
        order of `credit_fused_ff_bwd_bf16`'s arguments; None where unused:
        y = LN(x) (post-norm do2), a = GELU(h1), dh1, f32 dy (post-norm o2),
        the weight gradients' split partials, the db1 partials per row tile
        and the LN backward's dg | db | db2 partials per block."""
        m, ld, hd = self.m, self.ld, self.hidden
        bf, f32 = torch.bfloat16, torch.float32
        return {"y": ((m, ld), bf), "a": ((m, hd), bf), "dh": ((m, hd), bf),
                "dy": ((m, ld), f32),
                "p1": ((self.s1, ld, hd), f32) if self.s1 > 1 else None,
                "p2": ((self.s2, hd, ld), f32) if self.s2 > 1 else None,
                "pdb": ((-(-m // ROW_TILE), hd), f32),
                "pln": ((-(-m // self.ln_rows), 3, ld), f32)}


def wgrad_tiles(rows: int, cols: int, bn: int) -> int:
    """128 x bn output tiles of a rows x cols weight gradient."""
    return -(-rows // ROW_TILE) * -(-cols // bn)


def _wgrad_plan(rows: int, cols: int, m: int, sms: int):
    """(bn, splits) of an f32 rows x cols weight gradient contracted over m
    rows in K steps of 64, one block an SM. Splits only where the output
    has fewer tiles than the card has SMs; then the count whose waves x K
    steps a block (a block's step costing as BN + 64, as in `wgmma_bn`)
    plus the partials' traffic (each written, read, and the sum written)
    take least time, at least 8 K steps a split and none left empty; the
    fewest splits, then the larger BN, on a tie."""
    steps = -(-m // K_STEP)
    best = None
    for bn in BN_CHOICES[::-1]:
        tiles = wgrad_tiles(rows, cols, bn)
        top = 1 if tiles >= sms else max(1, steps // 8)
        for s in range(1, top + 1):
            per = -(-steps // s)
            s = -(-steps // per)  # no split left empty
            t = (-(-tiles * s // sms) * per * 2.0 * ROW_TILE * (bn + 64) * K_STEP / SM_FLOPS
                 + (s > 1) * (2 * s + 1) * rows * cols * 4 / HBM_BYTES_PER_S)
            if best is None or (t, s) < best[0]:
                best = ((t, s), bn, s)
    return best[1], best[2]


@functools.lru_cache(maxsize=1024)
def ffb_plan(m: int, c: int, hidden: int, post_norm: bool, sms: int = SMS) -> FFBPlan:
    """The bf16 backward's plan at m rows, width c and hidden width
    `hidden`: the LN backward at LN_ROWS rows a block, or 16 where that
    leaves fewer than two blocks an SM; o2 and dy by `wgmma_bn` over the
    row tiles; the weight gradients by `_wgrad_plan`."""
    ld, hpad = _up8(c), _up8(hidden)
    row_tiles = -(-m // ROW_TILE)
    bn_w1, s1 = _wgrad_plan(ld, hpad, m, sms)
    bn_w2, s2 = _wgrad_plan(hpad, ld, m, sms)
    ln_rows = LN_ROWS if -(-m // LN_ROWS) >= 2 * sms else 16
    bn = wgmma_bn(row_tiles, ld, sms)
    return FFBPlan(m, ld, hpad, ln_rows=ln_rows, bn_o2=bn if post_norm else 0, bn_dy=bn,
                   bn_w1=bn_w1, s1=s1, bn_w2=bn_w2, s2=s2)


def fused_ff_bwd(x, ct, g, b, w1, b1, w2, b2, post_norm: bool = False):
    """Backward of `fused_ff` at x (M, C) or (B, H, W, C) with cotangent ct
    of x's shape, any C and hidden width (zero-padded to multiples of 8 for
    TMA's 16-byte strides and the row vectors). bf16 runs on `ffb_plan`'s
    plan, f32 on FMA passes. Returns (dx, dg, db, dw1, db1, dw2, db2): dx in
    x's dtype, the rest f32."""
    if x.device.type == "cpu":
        return fused_ff_bwd_plain(x, ct, g, b, w1, b1, w2, b2, post_norm)
    plan = None
    if x.dtype == torch.bfloat16:
        m = x.numel() // x.shape[-1]
        plan = ffb_plan(m, x.shape[-1], w1.shape[1], bool(post_norm),
                        torch.cuda.get_device_properties(x.device).multi_processor_count)
    return fused_ff_bwd_planned(x, ct, g, b, w1, b1, w2, b2, post_norm, plan)


def fused_ff_bwd_planned(x, ct, g, b, w1, b1, w2, b2, post_norm: bool, plan: FFBPlan | None):
    """`fused_ff_bwd` on the card with a given bf16 plan (None for f32), so
    that a test or a measurement can run another tiling or split than
    `ffb_plan`'s. A launch adds one to `fused_ff_bwd.launches`."""
    c = x.shape[-1]
    hidden = w1.shape[1]
    if ct.shape != x.shape:
        raise ValueError(f"fused_ff_bwd: ct {tuple(ct.shape)} != x {tuple(x.shape)}")
    code = _build.dtype_code(x.dtype)
    ld, hpad = _up8(c), _up8(hidden)
    x2 = x.contiguous().reshape(-1, c)
    m = x2.shape[0]
    if (plan is None) != (code == _build.F32) or (
            plan is not None and (plan.m, plan.ld, plan.hidden) != (m, ld, hpad)):
        raise ValueError(f"fused_ff_bwd: plan {plan} does not fit {x.dtype} (M={m}, C={c}, "
                         f"hidden={hidden})")
    # b2 shifts the post-norm LN's statistics (the pre-norm kernel ignores it)
    x2, prm = _padded(x2, [t.to(x.dtype) for t in (g, b, w1, b1, w2, b2)], ld, hpad)
    ct2 = _pad_to(ct.to(x.dtype).reshape(-1, c), 1, ld)
    ins = _aligned([x2, ct2] + prm)
    p, i = ctypes.c_void_p, ctypes.c_int
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(ins[0])
    dln = torch.empty((3, ld), **f32)  # dg | db | db2
    dw1, db1, dw2 = (torch.empty((ld, hpad), **f32), torch.empty(hpad, **f32),
                     torch.empty((hpad, ld), **f32))
    outs = [t.data_ptr() for t in (dx, dln, dw1, db1, dw2)]
    if plan is None:
        nbytes = _build.function("credit_fused_ff_bwd_workspace", [i] * 3,
                                 ctypes.c_longlong)(m, ld, hpad)
        work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        fn = _build.function("credit_fused_ff_bwd_f32", [p] * 14 + [i] * 5 + [p])
        err = fn(*(t.data_ptr() for t in ins), *outs, work.data_ptr(), m, c, ld, hpad,
                 int(post_norm), _build.stream_ptr())
        _build.check(err, "credit_fused_ff_bwd_f32")
    else:
        work = [None if v is None else torch.empty(v[0], dtype=v[1], device=x.device)
                for v in plan.workspace().values()]
        fn = _build.function("credit_fused_ff_bwd_bf16", [p] * 21 + [i] * 12 + [p])
        err = fn(*(t.data_ptr() for t in ins), *outs,
                 *(None if t is None else t.data_ptr() for t in work), m, c, ld, hpad,
                 int(post_norm), plan.ln_rows, plan.bn_o2, plan.bn_dy, plan.bn_w1, plan.s1,
                 plan.bn_w2, plan.s2, _build.stream_ptr())
        _build.check(err, "credit_fused_ff_bwd_bf16")
    fused_ff_bwd.launches += 1
    if (ld, hpad) != (c, hidden):
        dx, dln = dx[:, :c], dln[:, :c]
        dw1, db1, dw2 = dw1[:c, :hidden], db1[:hidden], dw2[:hidden, :c]
    return dx.reshape(x.shape), dln[0], dln[1], dw1, db1, dw2, dln[2]


fused_ff_bwd.launches = 0


class _FusedFF(torch.autograd.Function):
    """Forward: kernel 1. Saves x and the parameters only; the backward
    (kernel 4) recomputes the LN, fc1, GELU (and post-norm fc2) from them."""

    @staticmethod
    def forward(ctx, x, g, b, w1, b1, w2, b2, post_norm):
        ctx.save_for_backward(x, g, b, w1, b1, w2, b2)
        ctx.post_norm = post_norm
        return fused_ff(x, g, b, w1, b1, w2, b2, post_norm)

    @staticmethod
    def backward(ctx, ct):
        x, *prm = ctx.saved_tensors
        dx, *grads = fused_ff_bwd(x, ct, *prm, post_norm=ctx.post_norm)
        return (dx, *(d.to(p.dtype) for d, p in zip(grads, prm)), None)


def fused_ff_diff(x, g, b, w1, b1, w2, b2, post_norm: bool = False) -> torch.Tensor:
    """Differentiable `fused_ff`: kernel 1 forward, kernel 4 backward, in
    either form. The parameter gradients come back in each parameter's own
    dtype."""
    return _FusedFF.apply(x, g, b, w1, b1, w2, b2, bool(post_norm))


# ------------------------------------------------------------ over tp ranks
# The FF with its hidden layer split over tensor-parallel ranks, as
# credit_tpu's _TP_RULES place fc1's columns and fc2's rows over tp: each
# rank runs `ff_partial` on its slice (kernel 1's split route up to fc2's f32
# output), the ranks' partials are all-reduced in f32, and `ff_finish` (the
# row pass) adds b2, the post-norm LN and the residual. Backward:
# `ff_finish_bwd` (the row pass's, whole on every rank, from the summed z),
# then `ff_partial_bwd` on the rank's slice (kernel 4's passes without the
# residual). The fused wgmma kernel cannot sum over ranks before its
# epilogue, so under tp every width runs these passes.
def ff_partial_plain(x, g, b, w1, b1, w2, post_norm: bool = False) -> torch.Tensor:
    """One rank's z = GELU(A w1 + b1) w2 in f32, A = LN(x) in x's dtype
    (pre-norm) or x (post-norm); GELU's output cast to x's dtype before
    fc2, as `fused_ff_plain`."""
    dt = x.dtype
    g, b, b1 = (t.to(dt).float() for t in (g, b, b1))
    y = x if post_norm else _ln(x.float(), g, b).to(dt)
    h = F.gelu(y.float() @ w1.to(dt).float() + b1).to(dt)
    return h.float() @ w2.to(dt).float()


def ff_finish_plain(x, z, g, b, b2, post_norm: bool = False) -> torch.Tensor:
    """The row pass over the ranks' summed z (f32): x + (z + b2), or x +
    LN(z + b2), cast to x's dtype before the residual."""
    dt = x.dtype
    g, b, b2 = (t.to(dt).float() for t in (g, b, b2))
    v = z.float() + b2
    if post_norm:
        v = _ln(v, g, b)
    return x + v.to(dt)


def ff_finish_bwd_plain(z, ct, g, b, b2, post_norm: bool = False):
    """The row pass's backward: (dz, dg, db, db2). dz is the cotangent of
    fc2's output in ct's dtype: ct itself (pre-norm) or the LN backward of
    z + b2 (post-norm), as `fused_ff_bwd_plain` rounds it; dg and db are
    None in pre-norm form (the input LN's are the ranks' share)."""
    dt = ct.dtype
    c = ct.shape[-1]
    ctf = ct.reshape(-1, c).float()
    if not post_norm:
        return ct, None, None, ctf.sum(0)
    g, b2 = g.to(dt).float(), b2.to(dt).float()
    ohat, rstd = _stats(z.reshape(-1, c).float() + b2)
    do2 = _ln_bwd(ctf * g, ohat, rstd)
    return (do2.to(dt).reshape(ct.shape), (ctf * ohat).sum(0), ctf.sum(0), do2.sum(0))


def ff_partial_bwd_plain(x, dz, g, b, w1, b1, w2, post_norm: bool = False):
    """One rank's path backward from dz, the cotangent of its z: (dx, dg,
    db, dw1, db1, dw2), dx without the residual's term in x's dtype,
    pre-norm dg and db this rank's share (zeros post-norm), f32 sums."""
    dt = x.dtype
    c = x.shape[-1]
    xf = x.reshape(-1, c).float()
    dzf = dz.reshape(-1, c).to(dt).float()
    g, b, b1 = (t.to(dt).float() for t in (g, b, b1))
    w1, w2 = w1.to(dt).float(), w2.to(dt).float()
    if post_norm:
        y = xf
    else:
        xhat, rstd = _stats(xf)
        y = (xhat * g + b).to(dt).float()
    h1 = y @ w1 + b1
    phi = 0.5 * (1.0 + torch.erf(h1 * SQRT1_2))
    a = (h1 * phi).to(dt).float()
    dw2 = a.T @ dzf
    dh1 = (dzf @ w2.T) * (phi + h1 * torch.exp(-0.5 * h1 * h1) * INV_SQRT_2PI)
    dh1r = dh1.to(dt).float()
    dw1 = y.T @ dh1r
    dy = dh1r @ w1.T
    if post_norm:
        dx, dg, db = dy, torch.zeros_like(g), torch.zeros_like(g)
    else:
        dg, db = (dy * xhat).sum(0), dy.sum(0)
        dx = _ln_bwd(dy * g, xhat, rstd)
    return dx.to(dt).reshape(x.shape), dg, db, dw1, dh1.sum(0), dw2


def _sms(x) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _ln_rows(m: int, sms: int) -> int:
    """Rows a block of an LN backward row pass (as `ffb_plan`'s)."""
    return LN_ROWS if -(-m // LN_ROWS) >= 2 * sms else 16


def _rank_params(prm, ld: int, hpad: int):
    """(g, b, w1, b1, w2) of one rank zero-padded to width ld and hidden
    width hpad (`_padded_params` without b2)."""
    g, b, w1, b1, w2 = prm
    return [_pad_to(g, 0, ld), _pad_to(b, 0, ld), _pad_to(_pad_to(w1, 0, ld), 1, hpad),
            _pad_to(b1, 0, hpad), _pad_to(_pad_to(w2, 0, hpad), 1, ld)]


def ff_partial(x, g, b, w1, b1, w2, post_norm: bool = False) -> torch.Tensor:
    """One tp rank's z (f32, x's shape) on its slice w1 (C, Hr), b1 (Hr,),
    w2 (Hr, C): bf16 on the split route's passes (`credit_ff_partial_split`:
    LN rows, fc1 + GELU and fc2 into f32 on wgmma), f32 on the FMA passes
    (`credit_ff_partial_passes`). A launch adds one to `ff_partial.launches`."""
    if x.device.type == "cpu":
        return ff_partial_plain(x, g, b, w1, b1, w2, post_norm)
    c, hidden = x.shape[-1], w1.shape[1]
    x2 = x.contiguous().reshape(-1, c)
    m = x2.shape[0]
    ld, hpad = _up8(c), _up8(hidden)
    prm = _rank_params([t.to(x.dtype) for t in (g, b, w1, b1, w2)], ld, hpad)
    x2, *prm = _aligned([_pad_to(x2, 1, ld)] + prm)
    z = torch.empty((m, ld), dtype=torch.float32, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    if x.dtype == torch.bfloat16:
        plan = _split_plan(m, c, hidden, bool(post_norm), _sms(x))
        y = None if plan.y is None else torch.empty(plan.y, dtype=x.dtype, device=x.device)
        h = torch.empty(plan.h, dtype=x.dtype, device=x.device)
        fn = _build.function("credit_ff_partial_split", [p] * 9 + [i] * 6 + [p])
        err = fn(*(t.data_ptr() for t in [x2] + prm), z.data_ptr(),
                 None if y is None else y.data_ptr(), h.data_ptr(), m, c, ld, hpad,
                 int(post_norm), plan.bn2, _build.stream_ptr())
        _build.check(err, "credit_ff_partial_split")
    else:
        _build.dtype_code(x.dtype)
        nbytes = _build.function("credit_fused_ff_passes_workspace", [i] * 3,
                                 ctypes.c_longlong)(m, ld, hpad)
        work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        fn = _build.function("credit_ff_partial_passes", [p] * 8 + [i] * 5 + [p])
        err = fn(*(t.data_ptr() for t in [x2] + prm), z.data_ptr(), work.data_ptr(), m, c, ld,
                 hpad, int(post_norm), _build.stream_ptr())
        _build.check(err, "credit_ff_partial_passes")
    ff_partial.launches += 1
    if ld != c:
        z = z[:, :c].contiguous()
    return z.reshape(x.shape)


ff_partial.launches = 0


def ff_finish(x, z, g, b, b2, post_norm: bool = False) -> torch.Tensor:
    """x + (z + b2) or x + LN(z + b2) in x's dtype, z (x's shape, f32) the
    ranks' summed partials: one row pass (`credit_ff_finish`). A launch adds
    one to `ff_finish.launches`."""
    if x.device.type == "cpu":
        return ff_finish_plain(x, z, g, b, b2, post_norm)
    c = x.shape[-1]
    ld = _up8(c)
    x2 = _pad_to(x.contiguous().reshape(-1, c), 1, ld)
    z2 = _pad_to(z.float().contiguous().reshape(-1, c), 1, ld)
    prm = [_pad_to(t.to(x.dtype), 0, ld) for t in (b2, g, b)]
    x2, z2, *prm = _aligned([x2, z2] + prm)
    out = torch.empty_like(x2)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("credit_ff_finish", [p] * 6 + [i] * 5 + [p])
    err = fn(x2.data_ptr(), z2.data_ptr(), *(t.data_ptr() for t in prm), out.data_ptr(),
             _build.dtype_code(x.dtype), x2.shape[0], c, ld, int(post_norm),
             _build.stream_ptr())
    _build.check(err, "credit_ff_finish")
    ff_finish.launches += 1
    return out[:, :c].reshape(x.shape)


ff_finish.launches = 0


def ff_finish_bwd(z, ct, g, b, b2, post_norm: bool = False):
    """The row pass's backward (`ff_finish_bwd_plain`'s function) on the
    card: post-norm the LN backward of z + b2 (`credit_ff_finish_bwd`: dz in
    ct's dtype, dg, db, db2), pre-norm dz = ct and db2 its column sums. A
    launch adds one to `ff_finish_bwd.launches`."""
    if ct.device.type == "cpu":
        return ff_finish_bwd_plain(z, ct, g, b, b2, post_norm)
    c = ct.shape[-1]
    ld = _up8(c)
    ct2 = _pad_to(ct.contiguous().reshape(-1, c), 1, ld)
    m = ct2.shape[0]
    z2 = (_pad_to(z.float().contiguous().reshape(-1, c), 1, ld) if post_norm
          else torch.empty(0, dtype=torch.float32, device=ct.device))
    prm = [_pad_to(t.to(ct.dtype), 0, ld) for t in (b2, g)]
    ct2, z2, *prm = _aligned([ct2, z2] + prm)
    rows = _ln_rows(m, _sms(ct))
    f32 = dict(dtype=torch.float32, device=ct.device)
    dln, pln = torch.empty((3, ld), **f32), torch.empty((-(-m // rows), 3, ld), **f32)
    dz = torch.empty_like(ct2) if post_norm else None
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("credit_ff_finish_bwd", [p] * 7 + [i] * 6 + [p])
    err = fn(z2.data_ptr() if post_norm else None, ct2.data_ptr(), *(t.data_ptr() for t in prm),
             None if dz is None else dz.data_ptr(), dln.data_ptr(), pln.data_ptr(),
             _build.dtype_code(ct.dtype), m, c, ld, int(post_norm), rows, _build.stream_ptr())
    _build.check(err, "credit_ff_finish_bwd")
    ff_finish_bwd.launches += 1
    if not post_norm:
        return ct, None, None, dln[2, :c]
    return dz[:, :c].reshape(ct.shape), dln[0, :c], dln[1, :c], dln[2, :c]


ff_finish_bwd.launches = 0


def ff_partial_bwd(x, dz, g, b, w1, b1, w2, post_norm: bool = False):
    """One tp rank's path backward (`ff_partial_bwd_plain`'s function) on
    the card: bf16 on kernel 4's wgmma passes with `ffb_plan`'s plan at the
    rank's hidden width (`credit_ff_partial_bwd_bf16`), f32 on its FMA
    passes (`credit_ff_partial_bwd_f32`). Returns (dx, dg, db, dw1, db1,
    dw2): dx in x's dtype without the residual's term, the rest f32. A
    launch adds one to `ff_partial_bwd.launches`."""
    if x.device.type == "cpu":
        return ff_partial_bwd_plain(x, dz, g, b, w1, b1, w2, post_norm)
    c, hidden = x.shape[-1], w1.shape[1]
    if dz.shape != x.shape:
        raise ValueError(f"ff_partial_bwd: dz {tuple(dz.shape)} != x {tuple(x.shape)}")
    ld, hpad = _up8(c), _up8(hidden)
    x2 = _pad_to(x.contiguous().reshape(-1, c), 1, ld)
    m = x2.shape[0]
    dz2 = _pad_to(dz.to(x.dtype).reshape(-1, c), 1, ld)
    prm = _rank_params([t.to(x.dtype) for t in (g, b, w1, b1, w2)], ld, hpad)
    ins = _aligned([x2, dz2] + prm)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(ins[0])
    dln = torch.empty((3, ld), **f32)
    dw1, db1, dw2 = (torch.empty((ld, hpad), **f32), torch.empty(hpad, **f32),
                     torch.empty((hpad, ld), **f32))
    outs = [t.data_ptr() for t in (dx, dln, dw1, db1, dw2)]
    p, i = ctypes.c_void_p, ctypes.c_int
    if x.dtype == torch.bfloat16:
        plan = ffb_plan(m, c, hidden, bool(post_norm), _sms(x))
        unused = ("y", "dy", "pln") if post_norm else ()
        work = [None if v is None or k in unused else torch.empty(v[0], dtype=v[1],
                                                                  device=x.device)
                for k, v in plan.workspace().items()]
        fn = _build.function("credit_ff_partial_bwd_bf16", [p] * 20 + [i] * 11 + [p])
        err = fn(*(t.data_ptr() for t in ins), *outs,
                 *(None if t is None else t.data_ptr() for t in work), m, c, ld, hpad,
                 int(post_norm), plan.ln_rows, plan.bn_dy, plan.bn_w1, plan.s1, plan.bn_w2,
                 plan.s2, _build.stream_ptr())
        _build.check(err, "credit_ff_partial_bwd_bf16")
    else:
        _build.dtype_code(x.dtype)
        nbytes = _build.function("credit_fused_ff_bwd_workspace", [i] * 3,
                                 ctypes.c_longlong)(m, ld, hpad)
        work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        fn = _build.function("credit_ff_partial_bwd_f32", [p] * 13 + [i] * 5 + [p])
        err = fn(*(t.data_ptr() for t in ins), *outs, work.data_ptr(), m, c, ld, hpad,
                 int(post_norm), _build.stream_ptr())
        _build.check(err, "credit_ff_partial_bwd_f32")
    ff_partial_bwd.launches += 1
    if (ld, hpad) != (c, hidden):
        dx, dln = dx[:, :c], dln[:, :c]
        dw1, db1, dw2 = dw1[:c, :hidden], db1[:hidden], dw2[:hidden, :c]
    return dx.reshape(x.shape), dln[0], dln[1], dw1, db1, dw2


ff_partial_bwd.launches = 0


class _FFPartial(torch.autograd.Function):
    """Forward: `ff_partial` (kernel 1's passes on this rank's slice).
    Saves x and the rank's parameters; the backward (`ff_partial_bwd`)
    recomputes the LN, fc1 and GELU."""

    @staticmethod
    def forward(ctx, x, g, b, w1, b1, w2, post_norm):
        ctx.save_for_backward(x, g, b, w1, b1, w2)
        ctx.post_norm = post_norm
        return ff_partial(x, g, b, w1, b1, w2, post_norm)

    @staticmethod
    def backward(ctx, dz):
        x, *prm = ctx.saved_tensors
        dx, *grads = ff_partial_bwd(x, dz.to(x.dtype), *prm, post_norm=ctx.post_norm)
        if ctx.post_norm:  # the output LN is the row pass's
            grads[0] = grads[1] = None
        return (dx, *(None if d is None else d.to(p.dtype) for d, p in zip(grads, prm)), None)


class _FFFinish(torch.autograd.Function):
    """Forward: `ff_finish` (the row pass). Saves the summed z (post-norm)
    and the parameters; backward `ff_finish_bwd`: the residual's gradient
    is ct, z's the cotangent of fc2's output (f32, as z)."""

    @staticmethod
    def forward(ctx, x, z, g, b, b2, post_norm):
        ctx.save_for_backward(z if post_norm else None, g, b, b2)
        ctx.post_norm = post_norm
        return ff_finish(x, z, g, b, b2, post_norm)

    @staticmethod
    def backward(ctx, ct):
        z, g, b, b2 = ctx.saved_tensors
        dz, dg, db, db2 = ff_finish_bwd(z, ct, g, b, b2, post_norm=ctx.post_norm)
        grads = [None if d is None else d.to(p.dtype) for d, p in ((dg, g), (db, b), (db2, b2))]
        return (ct, dz.float(), *grads, None)


def ff_over_tp(x, g, b, w1, b1, w2, b2, post_norm: bool, group, rank: int, tp: int):
    """x + FF(x) with the hidden layer split over the `tp` ranks of
    `group`: this rank (`rank`) takes fc1's columns and fc2's rows
    [rank Hd/tp, (rank + 1) Hd/tp) of the whole w1 (C, Hd), b1, w2 (Hd, C)
    (sliced here, then cast to x's dtype: autograd keeps the slice, not the
    whole weight), runs `ff_partial` on them, the partials are summed over
    the group in f32 and `ff_finish` adds b2, the post-norm LN and the
    residual once. Backward: the rank's input gradient summed over the
    group (`copy_to_group`), the residual's ct added once; the gradients of
    w1, b1, w2 (and the pre-norm LN's g, b) are this rank's share, b2's
    (and the post-norm LN's) whole on every rank."""
    from credit_torch.parallel.halo import all_reduce_sum, copy_to_group

    hidden = w1.shape[1]
    if hidden % tp:
        raise ValueError(f"a hidden width of {hidden} does not split over tensor={tp}")
    cols = slice(rank * hidden // tp, (rank + 1) * hidden // tp)
    dt = x.dtype
    z = _FFPartial.apply(copy_to_group(x, group), g, b, w1[:, cols].to(dt), b1[cols],
                         w2[cols].to(dt), bool(post_norm))
    z = all_reduce_sum(z, group, reduce_grad=False)
    return _FFFinish.apply(x, z, g, b, b2, bool(post_norm))

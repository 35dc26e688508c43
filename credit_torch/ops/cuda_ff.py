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
widths of 256 and up, widths past 1024 and widths that are not multiples of
8 run the split route (`credit_fused_ff_split`: LN rows, then fc1 and fc2
as TMA + wgmma GEMMs with the biases, GELU and residual in their epilogues,
the hidden activations in device memory once, in bf16); narrower bf16
widths and f32 widths up to 1024 run the fused kernel (the 4C hidden kept
on chip); wider or ragged f32 widths run the forward in passes
(`credit_fused_ff_passes`, in `csrc/fused_ff_bwd.cu`), and the backward's
passes take any C: in bf16 on the same wgmma mainloop as the split route,
with the tiles and splits `ffb_plan` picks, in f32 on FMA. Where C or the hidden width is not a multiple of 8 the
wrappers zero-pad them (a copy in, the result cut back); the kernels take
every LN statistic over the true C.
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
MAX_C = 1024  # widest channel count the fused kernel's register plan takes
# bf16: from this width on the split route is the faster (one H100, in turns
# with the fused kernel: 0.404-0.413 ms against 0.660-0.672 at C = 256,
# 72,000 rows; at C = 128 it read 0.72-0.74 against 0.80-0.81, but would
# hold a 295 MB hidden buffer at the WXFormer's stage 0: PERF.md)
SPLIT_MIN_C = 256
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
    """The same function in plain PyTorch, for x (..., C)."""
    dt = x.dtype
    g, b, b1, b2 = (t.to(dt).float() for t in (g, b, b1, b2))
    y = x if post_norm else _ln(x.float(), g, b).to(dt)
    h = y.float() @ w1.to(dt).float() + b1
    h = F.gelu(h).to(dt)
    o = h.float() @ w2.to(dt).float() + b2
    if post_norm:
        o = _ln(o, g, b)
    return x + o.to(dt)


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
    """True when the fused kernel (`csrc/fused_ff.cu`) takes width c:
    C % 8 == 0 and C <= MAX_C. Every other width runs a route with the
    hidden activations in device memory (`ff_plan`) on rows zero-padded to
    a multiple of 8."""
    return c % 8 == 0 and c <= MAX_C


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


def _padded(x2, prm, ld: int, hpad: int):
    """x (M, C) and (g, b, w1, b1, w2, b2) zero-padded to width ld and hidden
    width hpad: zeros add nothing to a product, GELU(0) = 0, and the kernels
    keep the padded columns out of every LN statistic."""
    g, b, w1, b1, w2, b2 = prm
    return _pad_to(x2, 1, ld), [
        _pad_to(g, 0, ld), _pad_to(b, 0, ld), _pad_to(_pad_to(w1, 0, ld), 1, hpad),
        _pad_to(b1, 0, hpad), _pad_to(_pad_to(w2, 0, hpad), 1, ld), _pad_to(b2, 0, ld)]


@dataclass(frozen=True)
class FFPlan:
    """How one `fused_ff` call runs: the route ("fused", "split" or
    "passes"), the width `ld` and hidden width `hidden` the kernels see
    (zero-padded), the split route's output columns a block of fc2 (`bn2`;
    fc1's tiles are fixed, `csrc/fused_ff.cu`), and the shapes of the
    workspace the wrapper allocates:
    the split route's y = LN(x) (pre-norm), hidden activations h and f32 z
    = fc2's output (post-norm); None where a route needs none."""

    route: str
    ld: int
    hidden: int
    bn2: int = 0
    y: tuple | None = None
    h: tuple | None = None
    z: tuple | None = None


def _fused_plan(c: int, hidden: int) -> FFPlan:
    """The fused bf16 kernel's: c padded to 128, 256, 512 or 1024 (the
    kernel takes each; the plan sends it C <= 128, and C = 192 padded to
    256), the hidden width to its chunk of cpad / 4."""
    cpad = 128
    while cpad < c:
        cpad *= 2
    return FFPlan("fused", cpad, -(-hidden // (cpad // 4)) * (cpad // 4))


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
    bf16: the split route from SPLIT_MIN_C on, past MAX_C and wherever c is
    not a multiple of 8, else the fused kernel. f32: the fused kernel where
    it takes c (`fused_width`), else the passes (ld, hidden padded to
    multiples of 8)."""
    if dtype == torch.bfloat16:
        if fused_width(c) and c < SPLIT_MIN_C:
            return _fused_plan(c, hidden)
        return _split_plan(m, c, hidden, post_norm, sms)
    if fused_width(c):
        return FFPlan("fused", c, hidden)
    return FFPlan("passes", _up8(c), _up8(hidden))


def fused_ff(x, g, b, w1, b1, w2, b2, post_norm: bool = False,
             route: str | None = None) -> torch.Tensor:
    """x (M, C) or (B, H, W, C); g, b, b2 (C,); w1 (C, Hd); b1 (Hd,); w2 (Hd, C).
    post_norm selects the SwinV2 form. Any C and Hd, on the route `ff_plan`
    picks; `route` ("fused" or "split", bf16) overrides it to compare the
    two where both take C. A launch adds one to `fused_ff.launches` and, on
    the split route, to `fused_ff.split_launches`."""
    if x.device.type == "cpu":
        return fused_ff_plain(x, g, b, w1, b1, w2, b2, post_norm)
    c = x.shape[-1]
    hidden = w1.shape[1]
    x2 = x.contiguous().reshape(-1, c)
    m = x2.shape[0]
    plan_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = ff_plan(m, c, hidden, x.dtype, bool(post_norm), plan_sms)
    if route is not None and route != plan.route:
        if x.dtype != torch.bfloat16 or route not in ("fused", "split") or not fused_width(c):
            raise ValueError(f"fused_ff: no {route} route at C={c} in {x.dtype}")
        plan = (_fused_plan(c, hidden) if route == "fused"
                else _split_plan(m, c, hidden, bool(post_norm), plan_sms))
    prm = [t.to(x.dtype) for t in (g, b, w1, b1, w2, b2)]
    p, i = ctypes.c_void_p, ctypes.c_int
    if plan.route == "fused":
        # zeros add nothing (GELU(0) = 0); the post-norm LN divides by the
        # true C and leaves the padded columns out
        gp, bp, w1p, b1p, w2p, b2p = prm
        prm = [_pad_to(gp, 0, plan.ld), _pad_to(bp, 0, plan.ld),
               _pad_to(_pad_to(w1p, 0, plan.ld), 1, plan.hidden), _pad_to(b1p, 0, plan.hidden),
               _pad_to(_pad_to(w2p, 0, plan.hidden), 1, plan.ld), _pad_to(b2p, 0, plan.ld)]
        x2, *prm = _aligned([x2] + prm)
        out = torch.empty_like(x2)
        fn = _build.function("credit_fused_ff", [p] * 8 + [i] * 6 + [p])
        err = fn(x2.data_ptr(), *(t.data_ptr() for t in prm), out.data_ptr(),
                 _build.dtype_code(x.dtype), m, c, plan.ld, plan.hidden, int(post_norm),
                 _build.stream_ptr())
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

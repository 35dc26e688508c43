"""The routes of the port's FF (kernel 1), its backward (kernel 4) and
window attention (kernel 3), and the card-side tests of every FF and conv
kernel.

`cuda_ff.ff_plan`, `cuda_ff.ffb_plan` and `cuda_attention.attention_plan`
pick each call's kernel and sizes in Python: these tests check them at the
paths' shapes and past them. The plain versions of the FF's fused form and
split route, the FF backward's at ragged shapes and the plain attention at
windows past one key block are held against credit_tpu's Pallas kernels run
interpreted and its reference compositions. The tests marked `cuda` hold
the kernels against their plain versions on a card. This file imports
credit_tpu's ops (jax only) and no flax model, so it collects on a machine
without flax: `python -m pytest tests/test_torch_port_kernels.py -m cuda`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu.ops import pallas_ff as jff
from credit_tpu.ops import window_attention as jwa
from credit_tpu.ops.pallas_attention import fused_window_attention as j_fused_attn
from credit_torch.ops import cuda_attention, cuda_conv, cuda_ff
from credit_torch.ops.cuda_attention import attention_plan
from credit_torch.ops.cuda_ff import ff_plan, ffb_plan

BF16, F32 = torch.bfloat16, torch.float32


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel(out, ref) -> float:
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-30))


def _ff_args(shape, seed=0, hidden=None):
    """x, ct and the six parameters of an FF at width shape[-1], numpy."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    hid = hidden or 4 * c
    return [rng.standard_normal(shape) * 0.4, rng.standard_normal(shape) * 0.3,
            rng.standard_normal(c) * 0.1 + 1.0, rng.standard_normal(c) * 0.1,
            rng.standard_normal((c, hid)) * 0.05, rng.standard_normal(hid) * 0.05,
            rng.standard_normal((hid, c)) * 0.05, rng.standard_normal(c) * 0.5]


# --------------------------------------------------------------- kernel 1
# (rows, C, hidden, post-norm) of every FF call on the paths (CONF_025's four
# stages, FuXi's SwinV2 MLP), and past them
FF_PATH = [(288000, 128, 512, False), (72000, 256, 1024, False), (18000, 512, 2048, False),
           (4500, 1024, 4096, False), (16905, 1024, 4096, True), (18000, 192, 768, True)]


@pytest.mark.parametrize("m,c,hidden,post", FF_PATH)
def test_ff_plan_at_path_shapes(m, c, hidden, post):
    """bf16 takes the split route past C = 256, with the hidden activations
    (and post-norm z, pre-norm y) as workspace; narrower widths the fused
    wgmma kernel, its tiles padded to 128 or 256 columns, hidden
    in chunks of 64, tiles of 64 rows a consumer warpgroup (three up to 128
    columns, two at 256) over one persistent block an SM (stage 0's 288,000
    rows: 1500 tiles on 132 blocks); f32 the fused kernel."""
    plan = ff_plan(m, c, hidden, BF16, post)
    if c > 256:
        assert (plan.route, plan.ld, plan.hidden) == ("split", c, hidden)
        assert plan.h == (m, hidden)
        assert (plan.y, plan.z) == ((None, (m, c)) if post else ((m, c), None))
        assert plan.bn2 == cuda_conv.wgmma_bn(-(-m // 128), c)  # fc2: the conv's tile rule
        assert plan.chunk == plan.rows == plan.grid == 0
    else:
        cpad = 128 if c <= 128 else 256  # C = 192 and 256
        assert (plan.route, plan.ld, plan.hidden) == ("fused", cpad, hidden)
        rows = 192 if cpad == 128 else 128
        assert (plan.chunk, plan.rows) == (64, rows)
        assert plan.grid == min(-(-m // rows), cuda_ff.SMS)
        assert plan.y is plan.h is plan.z is None
        assert plan.bn2 == 0
    if m == 288000:
        assert plan.grid == 132 and -(-m // plan.rows) == 1500
    assert ff_plan(m, c, hidden, F32, post).route == "fused"


@pytest.mark.parametrize("c,hidden,ld,hpad", [(1152, 4608, 1152, 4608), (100, 404, 104, 408),
                                              (2304, 9216, 2304, 9216), (160, 640, 256, 640),
                                              (64, 256, 64, 256), (72, 288, 128, 288),
                                              (248, 992, 256, 992), (96, 300, 128, 304)])
def test_ff_plan_past_the_paths(c, hidden, ld, hpad):
    """Widths past 1024 and ragged widths take the split route in bf16
    (padded to multiples of 8) and the passes in f32; every multiple of 8
    up to FUSED_MAX_C stays on the fused wgmma kernel, its tiles padded to
    64, 128 or 256 columns, the hidden width to a multiple of 8, on one
    block for each of 300 rows' tiles (192 rows up to 128 columns, 128
    past them)."""
    plan = ff_plan(300, c, hidden, BF16, True)
    assert (plan.ld, plan.hidden) == (ld, hpad)
    if c <= cuda_ff.FUSED_MAX_C and c % 8 == 0:
        rows = 192 if ld <= 128 else 128
        assert (plan.route, plan.chunk, plan.rows, plan.grid) == ("fused", 64, rows,
                                                                  -(-300 // rows))
        assert ff_plan(300, c, hidden, F32, False) == cuda_ff.FFPlan("fused", c, hidden)
        assert plan.chunk * -(-plan.hidden // plan.chunk) >= hidden
        return
    assert plan.route == "split" and plan.h == (300, hpad) and plan.z == (300, ld)
    assert ff_plan(300, c, hidden, BF16, False).y == (300, ld)
    f32 = ff_plan(300, c, hidden, F32, False)
    assert (f32.route, f32.ld, f32.hidden) == ("passes", ld, hpad)


# f32: the same math in another summation order and erff against the TPU
# kernel's A&S erf (1.5e-7): 1e-5 of max |out|. bf16: y, the hidden
# activations and fc2's output are rounded at the same points on both
# sides; a flipped rounding moves an output by a bf16 ulp of its ~1-4
# magnitude (2^-8 relative), and _xla_ff does not round the biases: 2e-2.
SPLIT_TOL = {F32: 1e-5, BF16: 2e-2}


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("post", [False, True], ids=["pre_norm", "post_norm"])
@pytest.mark.parametrize("c", [64, 100])
def test_split_plain_matches_pallas_and_xla(c, post, dtype):
    """The split route's passes (y, h in the compute dtype, z in f32, the row
    pass) against the TPU kernel interpreted and the XLA composition, at a
    width that needs no padding and one that does (100, hidden 404)."""
    x, _, *prm = _ff_args((2, 6, 10, c), seed=c, hidden=4 * c + 4 * (c % 8 != 0))
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    xj = jnp.asarray(x, jdt)
    pj = [jnp.asarray(p, jdt) for p in prm]
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(dtype)
    pt = [torch.from_numpy(np.asarray(p.astype(jnp.float32))).to(dtype) for p in pj]
    out = cuda_ff.fused_ff_split_plain(xt, *pt, post_norm=post)
    assert out.dtype == dtype and out.shape == xt.shape
    assert _rel(out, cuda_ff.fused_ff_plain(xt, *pt, post_norm=post)) == 0.0
    if c % 8 == 0:  # the TPU kernel's lane tiling takes C = 64, not 100
        ref = jff.fused_ff(xj, *pj, interpret=True, post_norm=post)
        assert _rel(out, ref) <= SPLIT_TOL[dtype]
    ref = jff._xla_ff(xj.reshape(-1, c), *pj, post_norm=post).reshape(xj.shape)
    assert _rel(out, ref) <= SPLIT_TOL[dtype]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,hidden,post", [(128, 512, False), (128, 512, True), (192, 768, True)],
                         ids=["C128_pre_norm", "C128_post_norm", "C192_post_norm"])
def test_fused_plain_matches_pallas_and_xla(c, hidden, post, dtype):
    """The fused kernel's plain version at the WXFormer's stage-0 width (C =
    128, hidden 512) in both forms and at C = 192 post-norm (which the
    kernel pads to 256), against the TPU kernel interpreted and the XLA
    composition (SPLIT_TOL: the same rounding points)."""
    x, _, *prm = _ff_args((2, 4, 10, c), seed=c + post, hidden=hidden)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    xj = jnp.asarray(x, jdt)
    pj = [jnp.asarray(p, jdt) for p in prm]
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(dtype)
    pt = [torch.from_numpy(np.asarray(p.astype(jnp.float32))).to(dtype) for p in pj]
    out = cuda_ff.fused_ff(xt, *pt, post_norm=post)  # a CPU tensor: the plain version
    assert out.dtype == dtype and out.shape == xt.shape
    assert torch.equal(out, cuda_ff.fused_ff_plain(xt, *pt, post_norm=post))
    ref = jff.fused_ff(xj, *pj, interpret=True, post_norm=post)
    assert _rel(out, ref) <= SPLIT_TOL[dtype]
    ref = jff._xla_ff(xj.reshape(-1, c), *pj, post_norm=post).reshape(xj.shape)
    assert _rel(out, ref) <= SPLIT_TOL[dtype]


# --------------------------------------------------------------- kernel 4
@pytest.mark.parametrize("m,c,hidden,post", FF_PATH)
def test_ffb_plan_at_path_shapes(m, c, hidden, post):
    """The bf16 backward's plan: the widths as they are (multiples of 8),
    o2 (post-norm only) and dy on the conv's tile rule, each weight
    gradient unsplit where it has a tile for every SM, else split over the
    rows with at least 8 K steps a split and none left empty; the
    workspace sized to the plan. Stage 0's 128 x 512 gradients split,
    FuXi's 1024 x 4096 do not."""
    plan = ffb_plan(m, c, hidden, post)
    assert (plan.m, plan.ld, plan.hidden) == (m, c, hidden)
    row_tiles = -(-m // 128)
    assert plan.bn_dy == cuda_conv.wgmma_bn(row_tiles, c)
    assert plan.bn_o2 == (cuda_conv.wgmma_bn(row_tiles, c) if post else 0)
    steps = -(-m // 64)
    for rows, cols, bn, splits in [(c, hidden, plan.bn_w1, plan.s1),
                                   (hidden, c, plan.bn_w2, plan.s2)]:
        assert bn in cuda_conv.BN_CHOICES
        if cuda_ff.wgrad_tiles(rows, cols, bn) >= cuda_conv.SMS:
            assert splits == 1
        per = -(-steps // splits)
        assert (splits - 1) * per < steps and (splits == 1 or per >= 8)
    if c == 128:
        assert plan.s1 > 1 and plan.s2 > 1
    if c == 1024:
        assert plan.s1 == plan.s2 == 1
    ws = plan.workspace()
    assert ws["a"][0] == ws["dh"][0] == (m, hidden) and ws["dy"][0] == (m, c)
    assert ws["p1"] == (None if plan.s1 == 1 else ((plan.s1, c, hidden), F32))
    assert ws["p2"] == (None if plan.s2 == 1 else ((plan.s2, hidden, c), F32))
    assert ws["pdb"][0] == (row_tiles, hidden)
    assert ws["pln"][0] == (-(-m // plan.ln_rows), 3, c)
    assert plan.ln_rows == (64 if -(-m // 64) >= 2 * cuda_conv.SMS else 16)


@pytest.mark.parametrize("m,c,hidden,ld,hpad", [(1000, 100, 404, 104, 408),
                                                (300, 1152, 4608, 1152, 4608),
                                                (130, 72, 200, 72, 200)])
def test_ffb_plan_past_the_paths(m, c, hidden, ld, hpad):
    """Ragged widths are padded to multiples of 8 (TMA's 16-byte strides).
    The splits follow the card: FuXi's weight gradients (128 tiles of 128 x
    256) stay whole on 132 SMs and split on a card of 200."""
    plan = ffb_plan(m, c, hidden, True)
    assert (plan.ld, plan.hidden) == (ld, hpad)
    assert plan.workspace()["y"][0] == (m, ld)
    assert cuda_ff.wgrad_tiles(1024, 4096, 256) == 128
    assert ffb_plan(16905, 1024, 4096, True, 132).s1 == 1
    assert ffb_plan(16905, 1024, 4096, True, 200).s1 > 1


# f32: erff against the TPU kernel's A&S erf (1.5e-7) and another summation
# order over the rows: 1e-5 of max |ref|. bf16: y, a, ct, do2 and dh1 are
# rounded at the same points on both sides; a flipped rounding (the erf,
# the order of the f32 sums before it) moves dx by a bf16 ulp of its
# magnitude (2^-8 relative) and a weight gradient by less: 2e-2.
FFB_TOL = {F32: 1e-5, BF16: 2e-2}


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("post", [False, True], ids=["pre_norm", "post_norm"])
@pytest.mark.parametrize("shape,hidden", [((2, 5, 13, 72), 200), ((1, 10, 13, 100), 404)],
                         ids=["C72_H200", "C100_H404"])
def test_ffb_plain_at_ragged_shapes_matches_pallas(shape, hidden, post, dtype):
    """The backward's plain version (the wrapper's CPU route) at M = 130
    rows (no multiple of the 128-row tiles), C and hidden no multiples of
    64 (72 and 200), and C and hidden the bf16 route pads (100 and 404, to
    104 and 408), against credit_tpu's fused_ff_bwd interpreted: dx and the
    six parameter gradients, in both forms."""
    a = _ff_args(shape, seed=shape[-1], hidden=hidden)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    aj = [jnp.asarray(v, jdt) for v in a]
    at = [torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(dtype) for v in aj]
    ref = jff.fused_ff_bwd(*aj, interpret=True, post_norm=post)
    out = cuda_ff.fused_ff_bwd(*at, post_norm=post)
    assert out[0].dtype == dtype and all(o.dtype == F32 for o in out[1:])
    for name, o, r in zip(["dx", "dg", "db", "dw1", "db1", "dw2", "db2"], out, ref):
        assert _rel(o, r) <= FFB_TOL[dtype], name


# --------------------------------------------------------------- kernel 3
# (windows, T, heads, dh) of every attention call on the CONF_025 paths:
# the local windows of each stage (T = 100) and the long ones (100, 25, 4, 1)
ATTN_PATH = [(2880, 100, 4, 32), (720, 100, 8, 32), (180, 100, 16, 32), (45, 100, 32, 32),
             (2880, 25, 8, 32), (1125, 4, 16, 32), (4500, 1, 32, 32)]


@pytest.mark.parametrize("windows,t,heads,dh", ATTN_PATH)
def test_attention_plan_at_path_shapes(windows, t, heads, dh):
    """bf16 q, k, v from the fused qkv projection take the tensor-core
    kernel: items of 4 heads (128 columns), one key block of T padded to 16
    (the exact softmax), T <= 8 packed 16 // T windows to a 16-row tile,
    every (head, query tile) pair on its own warp or two, a ring of two or
    more stages in shared memory, no more blocks than items."""
    inner = heads * dh
    plan = attention_plan(windows, t, dh, heads, BF16, (3 * inner, inner), True)
    wpi = 16 // t if t <= 8 else 1
    rt = -(-wpi * t // 16)
    assert (plan.kernel, plan.heads_per_item, plan.windows_per_item) == ("mma", 4, wpi)
    assert (plan.row_tiles, plan.key_block, plan.key_blocks) == (rt, 16 * rt, 1)
    pairs = 4 * rt
    assert plan.consumers <= 14 and -(-pairs // plan.consumers) <= 2
    assert plan.slots >= 2 and plan.smem <= cuda_attention.MAX_SMEM
    items = -(-windows // wpi) * (heads // 4)
    assert 1 <= plan.grid <= items
    f32 = attention_plan(windows, t, dh, heads, F32, (3 * inner, inner), True)
    assert (f32.kernel, f32.key_block, f32.key_blocks) == ("fma", t, 1)


@pytest.mark.parametrize("t,heads,dh,dtype,want", [
    (144, 4, 32, BF16, ("mma", 64, 3, 5)),    # online form: 2 query blocks of 80 rows
    (576, 4, 64, BF16, ("mma", 64, 9, 8)),    # 2 heads of 64 an item, 5 blocks of 128 rows
    (100, 2, 128, BF16, ("mma", 112, 1, 7)),  # one head of 128 an item
    (576, 4, 64, F32, ("fma", 384, 2, 0)),    # keys past shared memory: 2 blocks
    (144, 4, 32, F32, ("fma", 144, 1, 0)),
    (100, 2, 48, BF16, ("fma", 100, 1, 0)),   # no tensor-core head width
    (100, 2, 16, BF16, ("fma", 100, 1, 0)),   # 32 columns: no 64-column group
])
def test_attention_plan_past_the_paths(t, heads, dh, dtype, want):
    """Windows past 128 tokens run the online softmax over 64-key blocks on
    the tensor cores; f32 and other head widths the FMA kernel, whose key
    block is the whole window where it fits in shared memory."""
    inner = heads * dh
    plan = attention_plan(500, t, dh, heads, dtype, (3 * inner, inner), True)
    assert (plan.kernel, plan.key_block, plan.key_blocks, plan.row_tiles) == want
    assert plan.smem <= cuda_attention.MAX_SMEM
    if plan.kernel == "mma" and plan.key_blocks > 1:
        _, pmax = cuda_attention._mma_caps(dh)
        assert plan.heads_per_item * plan.row_tiles <= plan.consumers * pmax


def test_attention_plan_needs_tma_strides_and_alignment():
    """TMA reads 16-byte aligned rows with strides of multiples of 16 bytes:
    otherwise the FMA kernel runs."""
    assert attention_plan(10, 100, 32, 4, BF16, (384, 128), True).kernel == "mma"
    assert attention_plan(10, 100, 32, 4, BF16, (388, 128), True).kernel == "fma"
    assert attention_plan(10, 100, 32, 4, BF16, (384, 128), False).kernel == "fma"


def _online_reference(q, k, v, bias, heads, kb=64):
    """The kernel's online form in plain PyTorch: key blocks of kb, a
    running max and sum in f32, p = exp(s - m) rounded to v's dtype before
    P V, one division at the end."""
    b, nwin, t, inner = q.shape
    dh = inner // heads

    def split(z):
        return z.reshape(b, nwin, t, heads, dh).transpose(2, 3).float()

    qs = split(q * torch.tensor(dh ** -0.5, dtype=q.dtype))
    ks, vs = split(k), split(v)
    m = torch.full(qs.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qs)
    for j0 in range(0, t, kb):
        s = qs @ ks[..., j0:j0 + kb, :].transpose(-1, -2) + bias[:, j0:j0 + kb].float()
        mnew = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, e = torch.exp(m - mnew), torch.exp(s - mnew)
        l = l * corr + e.sum(-1, keepdim=True)
        o = o * corr + e.to(v.dtype).float() @ vs[..., j0:j0 + kb, :]
        m = mnew
    return (o / l).to(q.dtype).transpose(2, 3).reshape(b, nwin, t, inner)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [144, 450])
def test_attention_past_one_key_block_matches_pallas_and_reference(t, dtype):
    """The plain attention at windows the repaired kernel now takes (12x12
    and 450 tokens) against the TPU kernel interpreted and credit_tpu's
    jnp route (f32: summation order, 2e-5; bf16: p rounded at the same point
    against the kernel, 2e-2; the jnp route keeps bf16 scores past T = 32,
    5e-2), and the kernel's online form against the exact softmax (f32
    2e-5; bf16: exp(s - m) rounded to bf16 before the sum's division moves
    an output by about a bf16 ulp, 2e-2)."""
    heads, dh, nwin = 2, 32, 2
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((1, nwin, t, heads * dh)) for _ in range(3))
    bias = rng.standard_normal((t, t))
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jb = jnp.asarray(bias, jnp.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(dtype)
                  for a in (jq, jk, jv))
    tb = torch.from_numpy(bias.astype(np.float32))
    out = cuda_attention.fused_window_attention(tq, tk, tv, tb, heads)
    tol = 2e-5 if dtype == F32 else 2e-2
    assert _rel(out, j_fused_attn(jq, jk, jv, jb, heads, interpret=True)) <= tol
    assert _rel(out, jwa.window_attention(jq, jk, jv, jb, heads)) <= (
        tol if dtype == F32 else 5e-2)
    assert _rel(_online_reference(tq, tk, tv, tb, heads), out) <= tol


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


def _on(arrays, device, dtype):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_post_norm_kernels_match_plain_on_card(cuda, dtype):
    """Kernels 1 and 4 in post-norm mode against their plain versions, at
    C = 128 and at C = 192, which the bf16 forward pads to 256 (the padded
    columns must stay out of the LN statistics)."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for shape in [(3, 5, 7, 128), (2, 9, 11, 192)]:
        x, ct, *prm = _on(_ff_args(shape, seed=3), cuda, dtype)
        assert _rel(cuda_ff.fused_ff(x, *prm, post_norm=True),
                    cuda_ff.fused_ff_plain(x, *prm, post_norm=True)) < tol
        for o, r in zip(cuda_ff.fused_ff_bwd(x, ct, *prm, post_norm=True),
                        cuda_ff.fused_ff_bwd_plain(x, ct, *prm, post_norm=True)):
            assert _rel(o, r) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_on_card(cuda, dtype):
    """Kernel 5 at one case per tap group (2x2, rows of 3, 8x8) and kernel
    4 in pre-norm form, against their plain versions."""
    rng = np.random.default_rng(0)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for k in (2, 3, 8):
        x, gy = _on([rng.standard_normal((2, 13, 17, 24)),
                     rng.standard_normal((2, 14 - k, 18 - k, 40)) * 0.1], cuda, dtype)
        assert _rel(cuda_conv.conv2d_wgrad(x, gy, k, k),
                    cuda_conv.conv2d_wgrad_plain(x, gy, k, k)) < 1e-4, k
    a = _on(_ff_args((3, 5, 7, 64), seed=2), cuda, dtype)
    for o, r in zip(cuda_ff.fused_ff_bwd(*a), cuda_ff.fused_ff_bwd_plain(*a)):
        assert _rel(o, r) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("post", [False, True], ids=["pre_norm", "post_norm"])
def test_split_route_matches_plain_on_card(cuda, post):
    """The split route (wgmma GEMMs) in bf16 at C = 512 and 1024, ragged
    rows, a ragged width (100, hidden 404) and C = 1152, against its plain
    version (2e-2: the rounding points are the same, the sums' order is
    not); and at C = 128 and 256, where the fused kernel takes the width
    too, against the fused kernel."""
    for m, c, hidden in [(1000, 512, 2048), (333, 1024, 4096), (500, 100, 404),
                         (300, 1152, 4608)]:
        x, _, *prm = _on(_ff_args((m, c), seed=c, hidden=hidden), cuda, BF16)
        before = cuda_ff.fused_ff.split_launches
        out = cuda_ff.fused_ff(x, *prm, post_norm=post)
        assert cuda_ff.fused_ff.split_launches == before + 1
        assert _rel(out, cuda_ff.fused_ff_split_plain(x, *prm, post_norm=post)) < 2e-2
    for m, c, hidden in [(1000, 128, 512), (333, 256, 1024)]:
        x, _, *prm = _on(_ff_args((m, c), seed=c, hidden=hidden), cuda, BF16)
        out = cuda_ff.fused_ff(x, *prm, post_norm=post, route="split")
        assert _rel(out, cuda_ff.fused_ff_split_plain(x, *prm, post_norm=post)) < 2e-2
        fused = cuda_ff.fused_ff(x, *prm, post_norm=post, route="fused")
        assert _rel(fused, out) < 2e-2


# (rows, C, hidden, post-norm): the WXFormer's stage-0 width in both forms,
# C = 192 post-norm (padded to 256), C = 64; rows of one tile, of part of
# one and of several waves of the persistent blocks (at 100,000 rows each
# block reuses its x slots); C = 72 (padded to 128,
# hidden 288: part of a chunk), 160, 248, and hidden 300 (padded to 304)
FUSED_CARD = [(1000, 128, 512, False), (1000, 128, 512, True), (1000, 192, 768, True),
              (1000, 64, 256, False), (1000, 64, 256, True), (1, 128, 512, False),
              (127, 128, 512, True), (40000, 128, 512, False), (40000, 192, 768, True),
              (100000, 128, 512, False), (100000, 64, 256, True),
              (200, 72, 288, False), (500, 160, 640, False), (333, 248, 992, True),
              (300, 96, 300, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,hidden,post", FUSED_CARD)
def test_fused_wgmma_matches_plain_on_card(cuda, m, c, hidden, post):
    """The fused bf16 kernel (wgmma, the hidden layer in registers) against
    its plain version within 2e-2 of max |plain| (the rounding points are
    the same, the sums' order is not), one launch off the split route, and
    bitwise the same on a second call."""
    x, _, *prm = _on(_ff_args((m, c), seed=m + c, hidden=hidden), cuda, BF16)
    assert ff_plan(m, c, hidden, BF16, post).route == "fused"
    before = (cuda_ff.fused_ff.launches, cuda_ff.fused_ff.split_launches)
    out = cuda_ff.fused_ff(x, *prm, post_norm=post)
    assert (cuda_ff.fused_ff.launches, cuda_ff.fused_ff.split_launches) == (
        before[0] + 1, before[1])
    assert _rel(out, cuda_ff.fused_ff_plain(x, *prm, post_norm=post)) < 2e-2
    assert torch.equal(out, cuda_ff.fused_ff(x, *prm, post_norm=post))


@pytest.mark.cuda
@pytest.mark.parametrize("post", [False, True], ids=["pre_norm", "post_norm"])
def test_ffb_wgmma_route_matches_plain_on_card(cuda, post):
    """Kernel 4's bf16 route (every product on the wgmma mainloop) against
    its plain version (2e-2, FFB_TOL), at ragged rows, a ragged width (C =
    100 and hidden 404, padded to 104 and 408), a width of several
    128-column tiles (C = 320) and C = 1152, on the plan's tiles and splits
    and on other ones (split weight gradients where the plan keeps them
    whole and the reverse, other BN); each bitwise the same on a second
    call."""
    for m, c, hidden in [(1000, 100, 404), (777, 320, 1280), (300, 1152, 4608)]:
        x, ct, *prm = _on(_ff_args((m, c), seed=c, hidden=hidden), cuda, BF16)
        ref = cuda_ff.fused_ff_bwd_plain(x, ct, *prm, post_norm=post)
        plan = ffb_plan(m, c, hidden, post)
        other = dataclasses.replace(
            plan, bn_dy=64, bn_w1=192, bn_w2=64, ln_rows=16,
            s1=1 if plan.s1 > 1 else 3, s2=1 if plan.s2 > 1 else 2)
        for p in (plan, other):
            before = cuda_ff.fused_ff_bwd.launches
            out = cuda_ff.fused_ff_bwd_planned(x, ct, *prm, post, p)
            assert cuda_ff.fused_ff_bwd.launches == before + 1
            for name, o, r in zip(["dx", "dg", "db", "dw1", "db1", "dw2", "db2"], out, ref):
                assert _rel(o, r) < FFB_TOL[BF16], (m, c, p, name)
            again = cuda_ff.fused_ff_bwd_planned(x, ct, *prm, post, p)
            assert all(torch.equal(o, a) for o, a in zip(out, again)), (m, c, p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_match_plain_on_card(cuda, dtype):
    """Kernel 3 at the paths' windows (T = 100 at 4 and 32 heads, the packs
    of T = 4 and 1, T = 25), past one key block (T = 144, and T = 576 at
    heads of 64, which the kernel refused before), heads of 128 and of 16,
    q, k, v as views of one qkv projection, against the plain version."""
    rng = np.random.default_rng(5)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for nwin, t, heads, dh in [(30, 100, 4, 32), (3, 100, 32, 32), (37, 4, 16, 32),
                               (45, 1, 32, 32), (20, 25, 8, 32), (6, 144, 4, 32),
                               (3, 576, 4, 64), (8, 100, 2, 128), (8, 100, 8, 16)]:
        inner = heads * dh
        qkv, bias = _on([rng.standard_normal((1, nwin, t, 3 * inner)),
                         rng.standard_normal((t, t))], cuda, dtype)
        q, k, v = qkv.split(inner, dim=-1)
        out = cuda_attention.fused_window_attention(q, k, v, bias.float(), heads)
        ref = cuda_attention.fused_window_attention_plain(q, k, v, bias.float(), heads)
        assert _rel(out, ref) < tol, (t, heads, dh)

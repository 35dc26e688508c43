"""The feed-forward split over tensor-parallel ranks (`cuda_ff.ff_partial`,
`ff_finish`, `ff_finish_bwd`, `ff_partial_bwd`) against credit_tpu's FF on
the whole weights.

credit_tpu's TP rule (parallel/sharding.py `_TP_RULES`) places fc1's
columns and fc2's rows over 'tp'; GSPMD then runs its XLA composition
(`pallas_ff._xla_ff`) on each device's slice of the hidden layer and sums
fc2's partial outputs. Here the port's rank pieces run on the CPU (their
plain versions: the wrappers take that route for CPU tensors) on 2 and 4
slices of seeded weights, the ranks' f32 partials summed as the all-reduce
sums them, and the result is held against `_xla_ff` on the whole weights
(f32 1e-5; bf16 2e-2 of the largest value: the partials' f32 sum runs in
another order, so an output may round the other way by a bf16 ulp). The
backward pieces summed over the slices (the rank's input gradients plus
the residual's once; fc1's, b1's and fc2's slices side by side) are held
against `jax.vjp` of `_xla_ff` in f32 (1e-5) and against credit_tpu's
backward kernel interpreted in bf16 (its rounding points; 2e-2). The tests
marked `cuda` hold the kernels against their plain versions on a card,
and two ranks' partials through `ff_finish` against `fused_ff` on the
whole weights; they skip here. The card's machine has no flax: this file
imports none of credit_tpu's models, so `python -m pytest
tests/test_torch_port_ff_tp.py -m cuda` collects there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu.ops import pallas_ff as jff
from credit_torch.ops import cuda_ff
from torch_port_fixtures import two_torch_threads  # noqa: F401

BF16, F32 = torch.bfloat16, torch.float32
TOL = {F32: 1e-5, BF16: 2e-2}
# (x's shape, hidden): a width the kernels take as it is, and one they pad
# (C = 100; hidden 400 gives slices of 200 and 100, 100 not a multiple of 8)
SHAPES = [((2, 6, 10, 64), 256), ((1, 10, 13, 100), 400)]
SHAPE_IDS = ["C64_H256", "C100_H400"]


def _args(shape, hidden, seed):
    """x, ct and the six parameters of an FF at width shape[-1], numpy."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return [rng.standard_normal(shape) * 0.4, rng.standard_normal(shape) * 0.3,
            rng.standard_normal(c) * 0.1 + 1.0, rng.standard_normal(c) * 0.1,
            rng.standard_normal((c, hidden)) * 0.05, rng.standard_normal(hidden) * 0.05,
            rng.standard_normal((hidden, c)) * 0.05, rng.standard_normal(c) * 0.5]


def _both(arrays, dtype):
    """The arrays in the compute dtype for JAX, and the same values for the
    port."""
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    js = [jnp.asarray(a, jdt) for a in arrays]
    return js, [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype) for a in js]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel(out, ref) -> float:
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-30))


def _slices(hidden: int, tp: int):
    return [slice(r * hidden // tp, (r + 1) * hidden // tp) for r in range(tp)]


def _rank_prm(prm, cols):
    """(g, b, w1, b1, w2) of the rank owning hidden columns `cols`."""
    g, b, w1, b1, w2, _ = prm
    return [g, b, w1[:, cols], b1[cols], w2[cols]]


def tp_forward(x, prm, post, tp):
    """The ranks' partials summed in f32, then the row pass."""
    g, b, _, _, _, b2 = prm
    z = sum(cuda_ff.ff_partial(x, *_rank_prm(prm, cols), post_norm=post)
            for cols in _slices(prm[2].shape[1], tp))
    assert z.dtype == F32 and z.shape == x.shape
    return cuda_ff.ff_finish(x, z, g, b, b2, post_norm=post), z


def tp_backward(x, ct, prm, post, tp):
    """(dx, dg, db, dw1, db1, dw2, db2) as the ranks give them: the row
    pass's backward from the summed z, each rank's path from its dz, the
    input gradients summed and the residual's ct added once."""
    g, b, _, _, _, b2 = prm
    _, z = tp_forward(x, prm, post, tp)
    dz, dg, db, db2 = cuda_ff.ff_finish_bwd(z, ct, g, b, b2, post_norm=post)
    assert dz.dtype == x.dtype
    parts = [cuda_ff.ff_partial_bwd(x, dz, *_rank_prm(prm, cols), post_norm=post)
             for cols in _slices(prm[2].shape[1], tp)]
    dx = ct.float() + sum(p[0].float() for p in parts)
    if not post:  # the input LN's gradients are the ranks' shares
        assert dg is None and db is None
        dg, db = sum(p[1] for p in parts), sum(p[2] for p in parts)
    else:
        assert all(float(p[1].abs().max()) == 0.0 == float(p[2].abs().max()) for p in parts)
    return (dx, dg, db, torch.cat([p[3] for p in parts], 1), torch.cat([p[4] for p in parts]),
            torch.cat([p[5] for p in parts], 0), db2)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("post", [False, True], ids=["pre_norm", "post_norm"])
@pytest.mark.parametrize("shape,hidden", SHAPES, ids=SHAPE_IDS)
def test_partials_over_slices_match_reference_ff(shape, hidden, post, dtype):
    """ff_partial on 2 and 4 slices of the hidden layer, summed, then
    ff_finish: credit_tpu's XLA composition on the whole weights."""
    a = _args(shape, hidden, seed=shape[-1] + post)
    (xj, _, *pj), (xt, _, *pt) = _both(a, dtype)
    c = shape[-1]
    ref = jff._xla_ff(xj.reshape(-1, c), *pj, post_norm=post).reshape(xj.shape)
    for tp in (2, 4):
        out, _ = tp_forward(xt, pt, post, tp)
        assert out.dtype == dtype and out.shape == xt.shape
        assert _rel(out, ref) <= TOL[dtype], tp


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("post", [False, True], ids=["pre_norm", "post_norm"])
@pytest.mark.parametrize("shape,hidden", SHAPES, ids=SHAPE_IDS)
def test_partial_backward_over_slices_matches_reference(shape, hidden, post, dtype):
    """ff_finish_bwd, then ff_partial_bwd on 2 and 4 slices, assembled:
    dx and the six parameter gradients against jax.vjp of `_xla_ff` (f32)
    and credit_tpu's backward kernel interpreted (bf16)."""
    a = _args(shape, hidden, seed=shape[-1] + 2 + post)
    (xj, ctj, *pj), (xt, ctt, *pt) = _both(a, dtype)
    c = shape[-1]
    if dtype == F32:
        _, vjp = jax.vjp(lambda x, *p: jff._xla_ff(x, *p, post_norm=post), xj.reshape(-1, c),
                         *pj)
        ref = vjp(ctj.reshape(-1, c))
        ref = (ref[0].reshape(xj.shape), *ref[1:])
    else:
        ref = jff.fused_ff_bwd(xj, ctj, *pj, interpret=True, post_norm=post)
    for tp in (2, 4):
        out = tp_backward(xt, ctt, pt, post, tp)
        for name, o, r in zip(["dx", "dg", "db", "dw1", "db1", "dw2", "db2"], out, ref):
            assert _rel(o, r) <= TOL[dtype], (tp, name)


def test_over_tp_needs_a_dividing_hidden_width():
    """ff_over_tp refuses a hidden width the ranks do not split evenly (the
    layers replicate such an FF, as credit_tpu's param_spec does)."""
    x, _, *prm = [torch.from_numpy(np.asarray(v, np.float32)) for v in _args((1, 2, 3, 8), 30, 0)]
    with pytest.raises(ValueError, match="does not split over tensor=4"):
        cuda_ff.ff_over_tp(x, *prm, False, None, 0, 4)


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


def _on(arrays, device, dtype):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype) for a in arrays]


# (rows, C, this rank's hidden width, post-norm) on the card: the WXFormer's
# stage widths at hidden / 2 with ragged rows, FuXi's post-norm width, and a
# width and slice the wrappers pad
CARD = [(1000, 128, 256, False), (333, 512, 1024, False), (777, 1024, 2048, True),
        (500, 100, 202, False), (500, 100, 202, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_rank_kernels_match_plain_on_card(cuda, dtype):
    """ff_partial, ff_finish, ff_finish_bwd and ff_partial_bwd against
    their plain versions, each launch counted."""
    for m, c, hd, post in CARD:
        x, ct, g, b, w1, b1, w2, b2 = _on(_args((m, c), hd, seed=c + hd), cuda, dtype)
        n = [f.launches for f in (cuda_ff.ff_partial, cuda_ff.ff_finish, cuda_ff.ff_finish_bwd,
                                  cuda_ff.ff_partial_bwd)]
        z = cuda_ff.ff_partial(x, g, b, w1, b1, w2, post_norm=post)
        assert _rel(z, cuda_ff.ff_partial_plain(x, g, b, w1, b1, w2, post)) <= TOL[dtype]
        out = cuda_ff.ff_finish(x, z, g, b, b2, post_norm=post)
        assert _rel(out, cuda_ff.ff_finish_plain(x, z, g, b, b2, post)) <= TOL[dtype]
        got = cuda_ff.ff_finish_bwd(z, ct, g, b, b2, post_norm=post)
        want = cuda_ff.ff_finish_bwd_plain(z, ct, g, b, b2, post)
        for o, r in zip(got, want):
            assert (o is None) == (r is None) and (o is None or _rel(o, r) <= TOL[dtype])
        dz = got[0]
        for o, r in zip(cuda_ff.ff_partial_bwd(x, dz, g, b, w1, b1, w2, post_norm=post),
                        cuda_ff.ff_partial_bwd_plain(x, dz, g, b, w1, b1, w2, post)):
            assert float(r.abs().max()) == 0.0 == float(o.abs().max()) or _rel(o, r) <= TOL[dtype]
        assert [f.launches for f in (cuda_ff.ff_partial, cuda_ff.ff_finish, cuda_ff.ff_finish_bwd,
                                     cuda_ff.ff_partial_bwd)] == [v + 1 for v in n]


@pytest.mark.cuda
@pytest.mark.parametrize("post", [False, True], ids=["pre_norm", "post_norm"])
def test_two_ranks_sum_to_the_whole_ff_on_card(cuda, post):
    """Two ranks' ff_partial summed, then ff_finish, against fused_ff on the
    whole weights (bf16: the fused kernel at C = 128, the split route at
    1024), and the assembled backward against fused_ff_bwd."""
    for m, c in [(3000, 128), (700, 1024)]:
        x, ct, *prm = _on(_args((m, c), 4 * c, seed=c), cuda, BF16)
        out, _ = tp_forward(x, prm, post, 2)
        assert _rel(out, cuda_ff.fused_ff(x, *prm, post_norm=post)) <= TOL[BF16]
        for o, r in zip(tp_backward(x, ct, prm, post, 2),
                        cuda_ff.fused_ff_bwd(x, ct, *prm, post_norm=post)):
            assert _rel(o, r) <= TOL[BF16]

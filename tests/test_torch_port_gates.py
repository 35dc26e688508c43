"""The port's layers at widths and windows past its fastest kernels,
against credit_tpu.

The fused FF kernel takes C % 8 == 0 and C <= 1024; wider or ragged widths
run the same function in passes, with rows and the hidden width zero-padded
to multiples of 8 (`cuda_ff.fused_width`). Window attention on the tensor
cores takes bf16 windows of up to 128 tokens; other windows and head widths
run its FMA kernel. Either way the port's `FeedForward`, `SwinBlockV2` and
`WindowAttention` call the kernel wrappers for every shape, and on the CPU
the wrappers run their plain versions: these tests hold those against
credit_tpu, which sends such FF widths to its XLA composition. The kernels
themselves are held against the plain versions on the card (the `cuda`
tests of test_torch_port_ops.py and chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu.models.layers import FeedForward as JFeedForward
from credit_tpu.models.layers import WindowAttention as JWindowAttention
from credit_tpu.models.swin import SwinBlockV2 as JSwinBlockV2
from credit_torch.models import layers, swin
from credit_torch.models.layers import FeedForward, WindowAttention
from credit_torch.models.swin import SwinBlockV2
from credit_torch.ops import cuda_attention, cuda_ff

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: the same composition in f32, summation order only. bf16: both round
# LN, each GEMM and GELU to bf16 at the same points; one flipped rounding
# moves an output by a bf16 ulp of its ~1 magnitude (the FF tests' 0.05)
TOL = {"float32": 1e-5, "bfloat16": 0.05}


def _perturbed(params, seed):
    """The initialised parameters plus seeded noise, so that no bias is zero
    and no scale one (numpy arrays)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _state(params, prefix=""):
    out = {}
    for k, v in params.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_state(v, name) if isinstance(v, dict) else {name: torch.from_numpy(v)})
    return out


def _run_both(jmod, port, x_np, dtype, seed):
    """The reference and the port on the same input and parameters; returns
    both outputs as f32 numpy."""
    jdt, tdt = DTYPES[dtype]
    xj = jnp.asarray(x_np, jdt)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), xj)["params"], seed)
    ref = jmod.apply({"params": params}, xj)
    port.load_state_dict(_state(params))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    with torch.no_grad():
        out = port(xt)
    assert out.dtype == tdt
    return out.float().numpy(), np.asarray(jnp.asarray(ref, jnp.float32))


def _rel(out, ref) -> float:
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _spy(monkeypatch, module, name: str) -> list:
    """Replace module.name by a wrapper that records each call's first
    argument's shape; returns the record."""
    calls, fn = [], getattr(module, name)

    def spy(x, *args, **kw):
        calls.append(tuple(x.shape))
        return fn(x, *args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1152, 100])
def test_feedforward_beyond_the_kernel_widths_matches_reference(c, dtype, monkeypatch):
    """C = 1152 (> 1024) and C = 100 (% 8 != 0): credit_tpu's XLA route
    (fuse 'never') and the port's layer, which calls the FF wrapper (on a
    card: the forward in passes). Both round LN(x) and GELU's output to
    the compute dtype; XLA also rounds fc1's output before GELU."""
    assert not cuda_ff.fused_width(c)
    calls = _spy(monkeypatch, layers, "fused_ff_diff")
    x = np.random.default_rng(c).standard_normal((1, 3, 5, c)) * 0.5
    port = FeedForward(c, dtype=DTYPES[dtype][1])
    out, ref = _run_both(JFeedForward(dim=c, use_sn=False, dtype=DTYPES[dtype][0]), port, x,
                         dtype, seed=c)
    assert calls == [(1, 3, 5, c)]
    assert _rel(out, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,shift", [(1152, 0), (100, 2)])
def test_swin_block_mlp_beyond_the_kernel_widths_matches_reference(c, shift, dtype, monkeypatch):
    """The SwinV2 block's post-norm MLP at widths the fused kernel does not
    take, x + norm2(fc2(GELU(fc1(x)))), through the FF wrapper."""
    calls = _spy(monkeypatch, swin, "fused_ff_diff")
    x = np.random.default_rng(c + 1).standard_normal((1, 8, 8, c)) * 0.5
    jdt, tdt = DTYPES[dtype]
    port = SwinBlockV2(c, 4, 4, shift=shift, dtype=tdt)
    out, ref = _run_both(JSwinBlockV2(dim=c, num_heads=4, window_size=4, shift=shift, dtype=jdt),
                         port, x, dtype, seed=c + 1)
    assert calls == [(1, 8, 8, c)]
    assert _rel(out, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["short", "long"])
def test_window_attention_beyond_the_kernel_window_matches_reference(kind, dtype, monkeypatch):
    """12x12 windows (T = 144 > 128, the FMA kernel on a card) against
    credit_tpu's layer on its Pallas route, interpreted: the kernel's
    numerics (f32 scores, probabilities rounded to v's dtype)."""
    from credit_tpu.ops import pallas_attention

    monkeypatch.setattr(pallas_attention, "fused_window_attention",
                        functools.partial(pallas_attention.fused_window_attention,
                                          interpret=True))
    calls = _spy(monkeypatch, layers, "fused_window_attention_diff")
    x = np.random.default_rng(7).standard_normal((1, 24, 24, 64)) * 0.5
    jdt, tdt = DTYPES[dtype]
    port = WindowAttention(64, kind, 12, dim_head=32, dtype=tdt)
    out, ref = _run_both(JWindowAttention(dim=64, attn_type=kind, window_size=12, dim_head=32,
                                          use_sn=False, use_pallas=True, dtype=jdt),
                         port, x, dtype, seed=8)
    assert calls == [(1, 4, 144, 64)]
    # f32: summation order only; bf16: probabilities rounded at the same
    # point, the sums in another order
    assert _rel(out, ref) < {"float32": 1e-5, "bfloat16": 2e-2}[dtype]


def test_layers_take_the_kernels_where_they_fit(monkeypatch):
    """At the paths' shapes the layers call the same wrappers, and the FF
    widths are the fused kernel's."""
    ff, sw = _spy(monkeypatch, layers, "fused_ff_diff"), _spy(monkeypatch, swin, "fused_ff_diff")
    attn = _spy(monkeypatch, layers, "fused_window_attention_diff")
    assert cuda_ff.fused_width(64) and cuda_ff.fused_width(1024)
    with torch.no_grad():
        FeedForward(64)(torch.randn(1, 4, 4, 64))
        SwinBlockV2(64, 2, 4)(torch.randn(1, 8, 8, 64))
        WindowAttention(64, "short", 10, dim_head=32)(torch.randn(1, 10, 20, 64))
    assert (ff, sw, attn) == ([(1, 4, 4, 64)], [(1, 8, 8, 64)], [(1, 2, 100, 64)])


def test_kernel_wrappers_pad_those_widths():
    """The FF wrapper's zero-padding to multiples of 8 keeps every value and
    adds zeros only; the attention wrapper refuses only channels that do
    not split into the heads (meta tensors: nothing is launched)."""
    c, h = 100, 404
    assert [cuda_ff.fused_width(w) for w in (100, 1024, 1032, 1152, 2048)] == [
        False, True, False, False, False]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, c)).astype(np.float32))
    prm = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in [(c,), (c,), (c, h), (h,), (h, c), (c,)]]
    xp, pp = cuda_ff._padded(x, prm, cuda_ff._up8(c), cuda_ff._up8(h))
    assert xp.shape == (6, 104) and [tuple(t.shape) for t in pp] == [
        (104,), (104,), (104, 408), (408,), (408, 104), (104,)]
    for orig, padded in zip([x] + prm, [xp] + pp):
        cut = padded[tuple(slice(0, n) for n in orig.shape)]
        assert torch.equal(cut, orig)
        assert torch.count_nonzero(padded) == torch.count_nonzero(orig)  # the rest is zero
    q = torch.empty((1, 2, 144, 64), device="meta")
    with pytest.raises(ValueError, match="do not split"):
        cuda_attention.fused_window_attention(q, q, q, torch.empty((144, 144), device="meta"), 3)

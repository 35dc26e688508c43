"""Parity of the PyTorch port's ops (credit_torch.ops) with credit_tpu.

The same numpy inputs go through the JAX function and its port
counterpart on the CPU. For the three kernels the port's plain PyTorch
version (what its wrapper runs for a CPU tensor) is held against the Pallas
kernel run interpreted and against the reference composition. The CUDA
kernels themselves are held against the plain versions on the card by the
tests marked `cuda` and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.models import spectral_utils as jsu
from credit_tpu.ops import conv as jconv
from credit_tpu.ops import padding as jpad
from credit_tpu.ops import pallas_conv as jpc
from credit_tpu.ops import pallas_ff as jff
from credit_tpu.ops import upsample as jup
from credit_tpu.ops import window_attention as jwa
from credit_tpu.ops.pallas_attention import fused_window_attention as j_fused_attn
from credit_torch.data.channels import ChannelSchema
from credit_torch.models import spectral_utils as tsu
from credit_torch.ops import conv as tconv
from credit_torch.ops import cuda_attention, cuda_conv, cuda_ff
from credit_torch.ops import padding as tpad
from credit_torch.ops import upsample as tup
from credit_torch.ops import window_attention as twa

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(tdt)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel_err(out, ref) -> float:
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12))


# --------------------------------------------------------------- kernel 1
# f32: both accumulate in f32, so only the summation order differs (1e-5 of
# max |out| at these contraction depths). bf16: both round the f32 sum once;
# a different order can flip that rounding by one bf16 ulp (2^-8 relative).
CONV_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (1, 14, 21, 20, 8, 3, 3),    # ragged: odd spatial dims, cin not aligned
    (1, 22, 27, 16, 24, 8, 8),   # the stage-0 embed's 8x8 after space-to-depth
    (2, 12, 19, 48, 8, 2, 2),    # stage 1-3 embeds' 2x2 after space-to-depth
    (1, 15, 17, 16, 12, 3, 3),   # decoder residual / phase convs
])
def test_conv2d_valid_plain_matches_pallas(shape, dtype):
    n, hp, wp, cin, cout, kh, kw = shape
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((n, hp, wp, cin)) * 0.5, dtype)
    kj, kt = _pair(rng.standard_normal((kh, kw, cin, cout)) * 0.1, dtype)
    ref = jpc.conv2d_valid(xj, kj)  # interpreted on the CPU
    out = cuda_conv.conv2d_valid(xt, kt)  # CPU tensor: the plain version
    assert out.dtype == xt.dtype
    assert _rel_err(out, ref) < CONV_TOL[dtype]


# --------------------------------------------------------------- kernel 2
def _ff_inputs(m, c, seed=0):
    rng = np.random.default_rng(seed)
    h = 4 * c
    return [rng.standard_normal((m, c)) * 0.3, rng.standard_normal(c) * 0.1 + 1.0,
            rng.standard_normal(c) * 0.1, rng.standard_normal((c, h)) * 0.05,
            rng.standard_normal(h) * 0.02, rng.standard_normal((h, c)) * 0.05,
            rng.standard_normal(c) * 0.02]


# f32: erff / A&S erf (1.5e-7) and summation order, 1e-5 absolute at |out|
# ~1. bf16: LN and GELU outputs are rounded to bf16 before each product; one
# flipped rounding moves the output by a bf16 ulp of its ~1 magnitude, and
# against _xla_ff (which does not round the biases) a little more.
FF_TOL = {"float32": 1e-5, "bfloat16": 0.05}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["2d", "4d", "ragged_m"])
def test_fused_ff_plain_matches_pallas_and_xla(form, dtype):
    m = {"2d": 480, "4d": 2 * 10 * 16, "ragged_m": 500}[form]
    a = _ff_inputs(m, 128)
    xj, xt = _pair(a[0], dtype)
    wj = [jnp.asarray(v, jnp.float32) for v in a[1:]]
    for i in (2, 4):  # weights in the compute dtype, as the model passes them
        wj[i] = wj[i].astype(DTYPES[dtype][0])
    wt = [torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        DTYPES[dtype][1] if i in (2, 4) else torch.float32) for i, v in enumerate(wj)]
    if form == "4d":
        xj, xt = xj.reshape(2, 10, 16, 128), xt.reshape(2, 10, 16, 128)
    out = cuda_ff.fused_ff(xt, *wt)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    ref_kernel = jff.fused_ff(xj, *wj, interpret=True)
    ref_xla = jff._xla_ff(xj.reshape(-1, 128), *wj).reshape(xj.shape)
    np.testing.assert_allclose(_np(out), _np(ref_kernel), atol=FF_TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(ref_xla), atol=FF_TOL[dtype])


# --------------------------------------------------------------- kernel 3
@pytest.mark.parametrize("t", [1, 4, 25, 100, 144])
def test_window_attention_plain_matches_pallas_f32(t):
    """f32: scores and softmax in f32 on every side; only the summation
    order differs (2e-5)."""
    heads, dh, b, nwin = 2, 32, 1, 5
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((b, nwin, t, heads * dh)) for _ in range(3))
    bias = rng.standard_normal((t, t))
    jq, jk, jv, jb = (jnp.asarray(a, jnp.float32) for a in (q, k, v, bias))
    tq, tk, tv, tb = (torch.from_numpy(a.astype(np.float32)) for a in (q, k, v, bias))
    out = cuda_attention.fused_window_attention(tq, tk, tv, tb, heads)
    ref_kernel = j_fused_attn(jq, jk, jv, jb, heads, interpret=True)
    ref_plain = jwa.window_attention(jq, jk, jv, jb, heads)
    np.testing.assert_allclose(_np(out), _np(ref_kernel), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(out), _np(ref_plain), rtol=2e-5, atol=2e-5)
    # the port's copy of the reference's plain attention agrees too
    np.testing.assert_allclose(_np(twa.window_attention(tq, tk, tv, tb, heads)),
                               _np(ref_plain), rtol=2e-5, atol=2e-5)


def test_window_attention_plain_matches_pallas_bf16_strided_qkv():
    """bf16 at the flagship's T=100, with q, k, v as views of one fused qkv
    projection (token stride 3*inner). p is rounded to bf16 on both sides;
    a flipped rounding moves an output by about a bf16 ulp (2e-2)."""
    heads, dh, t, nwin = 4, 32, 100, 6
    inner = heads * dh
    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((1, nwin, t, 3 * inner))
    bias = rng.standard_normal((t, t))
    jqkv, tqkv = _pair(qkv, "bfloat16")
    jq, jk, jv = jnp.split(jqkv, 3, axis=-1)
    tq, tk, tv = tqkv.split(inner, dim=-1)
    out = cuda_attention.fused_window_attention(tq, tk, tv, torch.from_numpy(bias).float(), heads)
    ref = j_fused_attn(jq, jk, jv, jnp.asarray(bias, jnp.float32), heads, interpret=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("t", [9, 100])
def test_reference_window_attention_copy_bf16(t):
    """The port's copy of the reference's plain attention keeps its bf16
    routes (bf16 scores above T=32): within bf16 rounding of each other."""
    heads, dh, nwin = 2, 32, 4
    rng = np.random.default_rng(t)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.standard_normal((1, nwin, t, heads * dh)),
                                          "bfloat16") for _ in range(3))
    bias = rng.standard_normal((t, t))
    ref = jwa.window_attention(jq, jk, jv, jnp.asarray(bias, jnp.float32), heads)
    out = twa.window_attention(tq, tk, tv, torch.from_numpy(bias).float(), heads)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=5e-2, atol=5e-2)


# --------------------------------------------------------------- convs
@pytest.mark.parametrize("case", [
    (15, 21, 4, 2, 1),   # stride 2, odd dims: zero extension of the s2d form
    (16, 22, 8, 2, 3),   # stride 2, even dims, the embeds' 8x8
    (14, 19, 2, 2, 0),   # stride 2, k2/p0
    (15, 21, 3, 1, 1),   # stride 1, 3x3 residual conv
    (15, 21, 1, 1, 0),   # 1x1 GEMM
])
def test_conv2d_matches_reference(case):
    h, w, k, s, p = case
    rng = np.random.default_rng(h + k)
    x = rng.standard_normal((2, h, w, 6)).astype(np.float32)
    kern = (rng.standard_normal((k, k, 6, 10)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias), stride=s, padding=p)
    out = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(kern), torch.from_numpy(bias),
                       stride=s, padding=p)
    assert _rel_err(out, ref) < 1e-5  # f32, summation order only


@pytest.mark.parametrize("k,p", [(2, 0), (4, 1)])
def test_conv_transpose2d_matches_reference(k, p):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((1, 7, 11, 8)).astype(np.float32)
    kern = (rng.standard_normal((k, k, 8, 5)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    ref = jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias),
                                 stride=2, padding=p)
    out = tconv.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(kern),
                                 torch.from_numpy(bias), stride=2, padding=p)
    assert _rel_err(out, ref) < 1e-5


# Convs the reference computes through lax.conv_general_dilated (no Pallas
# kernel), which the port runs on PyTorch's own convolutions: conv2d at
# other strides and with credit_tpu's padding forms (a (h, w) pair, lax's
# strings; stride 1 and 2 stay on kernel 2's routes), every other transpose,
# and conv3d past the patch form.
CONV2D_FORMS = [  # (kernel, stride, padding)
    (3, 3, 1), (3, (1, 2), 1), (3, 3, "SAME"), (4, 1, "SAME"), (3, 2, "SAME"),
    (3, 1, "VALID"), (5, (3, 1), (1, 2)), (4, 2, "SAME_LOWER")]
TRANSPOSE_FORMS = [(3, 2, 1), (3, 1, 1), (4, 3, 0), (5, 2, 2), (2, 2, 1), (3, (2, 3), (1, 0))]
CONV3D_FORMS = [((2, 3, 3), (1, 2, 2), 1), ((3, 3, 3), 1, ((1, 0), (0, 1), (1, 1))),
                ((2, 2, 2), 2, "SAME"), ((1, 3, 3), (1, 1, 1), "VALID")]


@pytest.mark.parametrize("op,case", [("conv2d", c) for c in CONV2D_FORMS]
                         + [("conv_transpose2d", c) for c in TRANSPOSE_FORMS]
                         + [("conv3d", c) for c in CONV3D_FORMS])
def test_conv_forms_past_the_kernels_match_reference(op, case):
    k, stride, padding = case
    rng = np.random.default_rng(len(str(case)))
    if op == "conv3d":
        x = rng.standard_normal((1, 5, 9, 10, 3)).astype(np.float32)
        kern = (rng.standard_normal(tuple(k) + (3, 4)) * 0.2).astype(np.float32)
    else:
        x = rng.standard_normal((2, 13, 17, 5)).astype(np.float32)
        kern = (rng.standard_normal((k, k, 5, 4)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    ref = getattr(jconv, op)(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias),
                             stride=stride, padding=padding)
    out = getattr(tconv, op)(torch.from_numpy(x), torch.from_numpy(kern), torch.from_numpy(bias),
                             stride=stride, padding=padding)
    assert _rel_err(out, ref) < 1e-5  # f32, summation order only


def test_conv_unported_strides_raise():
    """The stride-3 conv and the k3/s2/p0 transpose raised until the port
    took every form the reference computes: neither raises now, and both
    agree with credit_tpu."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 8, 8, 2)).astype(np.float32)
    kern = (rng.standard_normal((3, 3, 2, 2)) * 0.3).astype(np.float32)
    for op, stride, padding in [("conv2d", 3, 1), ("conv_transpose2d", 2, 0)]:
        ref = getattr(jconv, op)(jnp.asarray(x), jnp.asarray(kern), stride=stride,
                                 padding=padding)
        out = getattr(tconv, op)(torch.from_numpy(x), torch.from_numpy(kern), stride=stride,
                                 padding=padding)
        assert _rel_err(out, ref) < 1e-5


# --------------------------------------------------------------- padding
@pytest.mark.parametrize("mode", ["earth", "mirror"])
def test_padding_matches_reference(mode):
    x = np.random.default_rng(3).standard_normal((2, 1, 9, 16, 3)).astype(np.float32)
    kw = {"mode": mode, "pad_lat": (3, 4), "pad_lon": (2, 1)}
    jp, tp = jpad.TensorPadding(**kw), tpad.TensorPadding(**kw)
    ref = jp.pad(jnp.asarray(x))
    out = tp.pad(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(out), _np(ref))
    np.testing.assert_array_equal(_np(tp.unpad(out)), x)


def test_earth_pad_rolls_pole_rows_then_flips():
    x = torch.arange(3 * 8, dtype=torch.float32).reshape(1, 3, 8, 1)
    out = tpad.earth_pad(x, (2, 1), (0, 0))
    ref = jpad.earth_pad(jnp.asarray(x.numpy()), (2, 1), (0, 0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # the north pad row next to the field is row 0 rolled by 180 degrees
    np.testing.assert_array_equal(out[0, 1, :, 0].numpy(), np.roll(x[0, 0, :, 0].numpy(), 4))


# --------------------------------------------------------------- windows
@pytest.mark.parametrize("kind", ["short", "long"])
def test_window_partition_roundtrip_matches_reference(kind):
    x = np.random.default_rng(4).standard_normal((2, 12, 18, 5)).astype(np.float32)
    ref = jwa.window_partition(jnp.asarray(x), 3, kind)
    out = twa.window_partition(torch.from_numpy(x), 3, kind)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    back = twa.window_unpartition(out, 3, 12, 18, kind)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jwa.window_unpartition(ref, 3, 12, 18, kind)))


@pytest.mark.parametrize("wsz", [1, 2, 5, 10])
def test_relative_position_tables_match_reference(wsz):
    np.testing.assert_array_equal(twa.relative_position_index(wsz),
                                  jwa.relative_position_index(wsz))
    np.testing.assert_array_equal(twa.relative_position_grid(wsz),
                                  jwa.relative_position_grid(wsz))


# --------------------------------------------------------------- upsample
def test_pixel_shuffle_matches_reference():
    x = np.random.default_rng(5).standard_normal((2, 3, 4, 12)).astype(np.float32)
    np.testing.assert_array_equal(tup.pixel_shuffle(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jup.pixel_shuffle(jnp.asarray(x), 2)))


@pytest.mark.parametrize("out_hw", [(13, 20), (7, 10), (16, 24)])
def test_bilinear_resize_matches_reference(out_hw):
    """Growing, shrinking (the reference antialiases) and the identity."""
    x = np.random.default_rng(6).standard_normal((1, 16, 24, 3)).astype(np.float32)
    ref = jup.bilinear_resize(jnp.asarray(x), *out_hw)
    out = tup.bilinear_resize(torch.from_numpy(x), *out_hw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- channels
_DATA = {"data": {"source": {"ERA5": {
    "levels": [0.0, 1.0],
    "variables": {"prognostic": {"vars_3D": ["U", "T"], "vars_2D": ["SP"]},
                  "static": {"vars_2D": ["Z"]},
                  "dynamic_forcing": {"vars_2D": ["TISR", "SST"]},
                  "diagnostic": {"vars_2D": ["PRECIP"]}}}}}}


@pytest.mark.parametrize("with_forcing", [False, True])
def test_update_x_matches_reference(with_forcing):
    js, ts = JSchema.from_config(_DATA), ChannelSchema.from_config(_DATA)
    assert ts.input_names == js.input_names and ts.target_names == js.target_names
    assert ts.input_segments() == js.input_segments()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 1, 4, 6, js.n_input)).astype(np.float32)
    y = rng.standard_normal((1, 1, 4, 6, js.n_target)).astype(np.float32)
    f = rng.standard_normal((1, 1, 4, 6, 2)).astype(np.float32) if with_forcing else None
    ref = js.update_x(jnp.asarray(x), jnp.asarray(y), None if f is None else jnp.asarray(f))
    out = ts.update_x(torch.from_numpy(x), torch.from_numpy(y),
                      None if f is None else torch.from_numpy(f))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# --------------------------------------------------------------- spectral
def test_converge_and_fold_spectral_match_reference():
    rng = np.random.default_rng(9)
    params = {"a": {"kernel": rng.standard_normal((3, 3, 4, 6)).astype(np.float32),
                    "bias": np.zeros(6, np.float32)},
              "b": {"c": {"kernel": rng.standard_normal((5, 7)).astype(np.float32)}}}
    spectral = {"a": {"u": rng.standard_normal(6).astype(np.float32),
                      "v": rng.standard_normal(36).astype(np.float32)},
                "b": {"c": {"u": rng.standard_normal(7).astype(np.float32),
                            "v": rng.standard_normal(5).astype(np.float32)}}}
    jv = jsu.fold_spectral(jsu.converge_spectral({"params": params, "spectral": spectral}))
    to_t = lambda d: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v)  # noqa: E731
                      for k, v in d.items()}
    tv = tsu.fold_spectral(tsu.converge_spectral({"params": to_t(params),
                                                  "spectral": to_t(spectral)}))
    assert "spectral" not in tv
    for path in (("a", "kernel"), ("a", "bias"), ("b", "c", "kernel")):
        j, t = jv["params"], tv["params"]
        for p in path:
            j, t = j[p], t[p]
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    # folded kernels have spectral norm 1
    w = tv["params"]["b"]["c"]["kernel"]
    assert abs(torch.linalg.matrix_norm(w.double(), ord=2).item() - 1.0) < 1e-4


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    # 3x3; channels not multiples of 8 (bf16: padded by the wrapper); a
    # kernel taller than wide; 2x2 over two K chunks to a ragged N tile; a
    # flat output (64-wide tiles); 8x8
    for n, h, w, cin, kh, kw, cout in [(1, 21, 37, 24, 3, 3, 40), (1, 14, 21, 20, 3, 3, 12),
                                       (1, 20, 30, 72, 3, 2, 64), (2, 12, 19, 128, 2, 2, 200),
                                       (1, 4, 70, 64, 3, 3, 136), (1, 24, 27, 24, 8, 8, 40)]:
        x = torch.randn((n, h, w, cin), generator=g, device=cuda).to(dtype)
        k = (torch.randn((kh, kw, cin, cout), generator=g, device=cuda) * 0.1).to(dtype)
        out = cuda_conv.conv2d_valid(x, k)
        assert out.shape == (n, h - kh + 1, w - kw + 1, cout) and out.is_contiguous()
        assert _rel_err(out.cpu(), cuda_conv.conv2d_valid_plain(x, k).cpu()) < tol, (cin, kh, kw)
    xf = torch.randn((3, 5, 7, 64), generator=g, device=cuda).to(dtype)
    prm = [torch.randn(s, generator=g, device=cuda).to(dtype) * 0.1
           for s in [(64,), (64,), (64, 256), (256,), (256, 64), (64,)]]
    assert _rel_err(cuda_ff.fused_ff(xf, *prm).cpu(), cuda_ff.fused_ff_plain(xf, *prm).cpu()) < tol
    qkv = torch.randn((1, 6, 25, 3 * 64), generator=g, device=cuda).to(dtype)
    q, kk, v = qkv.split(64, dim=-1)
    bias = torch.randn((25, 25), generator=g, device=cuda)
    assert _rel_err(cuda_attention.fused_window_attention(q, kk, v, bias, 2).cpu(),
                    cuda_attention.fused_window_attention_plain(q, kk, v, bias, 2).cpu()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ff_and_attention_past_the_fast_kernels_match_plain_on_card(cuda, dtype):
    """The FF forward in passes and its backward at C > 1024 (2304: the LN
    backward's column passes), C and hidden not multiples of 8 (padded by
    the wrappers), both forms; attention on the FMA kernel at T = 144 and
    at heads of 128."""
    g = torch.Generator(device=cuda).manual_seed(1)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for m, c, hd, post in [(300, 1152, 4608, False), (300, 1152, 4608, True),
                           (90, 2304, 9216, False), (90, 2304, 9216, True),
                           (500, 100, 404, False), (500, 100, 404, True)]:
        x = torch.randn((m, c), generator=g, device=cuda).to(dtype)
        ct = (0.1 * torch.randn((m, c), generator=g, device=cuda)).to(dtype)
        prm = [1 + 0.1 * torch.randn(c, generator=g, device=cuda),
               0.1 * torch.randn(c, generator=g, device=cuda),
               torch.randn((c, hd), generator=g, device=cuda) / c ** 0.5,
               0.02 * torch.randn(hd, generator=g, device=cuda),
               torch.randn((hd, c), generator=g, device=cuda) / hd ** 0.5,
               0.02 * torch.randn(c, generator=g, device=cuda)]
        prm = [p.to(dtype) for p in prm]
        out = cuda_ff.fused_ff(x, *prm, post_norm=post)
        assert out.shape == x.shape and out.dtype == dtype
        assert _rel_err(out.cpu(), cuda_ff.fused_ff_plain(x, *prm, post_norm=post).cpu()) < tol
        got = cuda_ff.fused_ff_bwd(x, ct, *prm, post_norm=post)
        want = cuda_ff.fused_ff_bwd_plain(x, ct, *prm, post_norm=post)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert _rel_err(a.cpu(), b.cpu()) < tol, (c, post)
    for nwin, t, heads, dh in [(40, 144, 4, 32), (40, 100, 2, 128)]:
        qkv = torch.randn((1, nwin, t, 3 * heads * dh), generator=g, device=cuda).to(dtype)
        q, kk, v = qkv.split(heads * dh, dim=-1)
        bias = torch.randn((t, t), generator=g, device=cuda)
        assert _rel_err(cuda_attention.fused_window_attention(q, kk, v, bias, heads).cpu(),
                        cuda_attention.fused_window_attention_plain(q, kk, v, bias,
                                                                    heads).cpu()) < tol

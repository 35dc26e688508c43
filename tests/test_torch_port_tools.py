"""Parity of the port's tool benches and their kernels' plain versions with
the JAX package's probes (tools/bench_pallas_conv.py, tools/bench_conv_ffk.py).

On the CPU the row-band conv drafts (kernels 6a and 6b) and the identity
copy (kernel 7) run their plain versions, which are held against
`cuda_conv.conv2d_valid_plain` and the TPU tool's own `xla_conv` (its file
loaded by path) on seeded numpy inputs; the conv + 4 FF composition of
`bench_conv_ffk` against credit_tpu's conv2d and `_xla_ff`. The CUDA
kernels themselves are held against the plain versions by the tests marked
`cuda` and by chip_smoke.py.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu.ops import conv as jconv
from credit_tpu.ops import pallas_ff as jff
from credit_torch.ops import conv as tconv
from credit_torch.ops import cuda_conv, cuda_ff, cuda_probes
from credit_torch.tools import bench_conv, bench_conv_ffk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32: f32 sums in other orders; bf16: both round the f32 sum once, and
# XLA's bf16 conv may round once more
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _rel(out, ref) -> float:
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(
        jnp.asarray(ref, jnp.float32))
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


# ------------------------------------------------------------ kernels 6a, 6b
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["dma", "halo"])
@pytest.mark.parametrize("shape", [
    (1, 20, 27, 16, 8, 2, 7),    # 2x2, bands of 7 rows
    (2, 17, 22, 24, 16, 3, 5),   # 3x3, ragged last band
    (1, 31, 40, 16, 24, 8, 24),  # the probes' 8x8 at their TH
])
def test_band_conv_plain_matches_conv2d_valid_and_tool(shape, form, dtype):
    n, hp, wp, cin, cout, k, th = shape
    rng = np.random.default_rng(hp + k)
    xj, xt = _pair(rng.standard_normal((n, hp, wp, cin)) * 0.5, dtype)
    kj, kt = _pair(rng.standard_normal((k, k, cin, cout)) * 0.1, dtype)
    plain = {"dma": cuda_probes.conv_band_dma_plain, "halo": cuda_probes.conv_band_halo_plain}[form]
    wrapper = {"dma": cuda_probes.conv_band_dma, "halo": cuda_probes.conv_band_halo}[form]
    out = plain(xt, kt, th)
    assert out.dtype == xt.dtype
    assert _rel(out, cuda_conv.conv2d_valid_plain(xt, kt)) < TOL[dtype]
    assert _rel(out, _tool("bench_pallas_conv").xla_conv(xj, kj)) < TOL[dtype]
    # a CPU tensor takes the plain version
    assert torch.equal(wrapper(xt, kt, th), out)


def test_band_conv_plain_checks_band_rows():
    x, k = torch.zeros((1, 9, 9, 8)), torch.zeros((2, 2, 8, 8))
    for fn in (cuda_probes.conv_band_dma, cuda_probes.conv_band_halo):
        with pytest.raises(ValueError, match="th="):
            fn(x, k, 33)


# ------------------------------------------------------------ kernel 7
@pytest.mark.parametrize("shape,dtype", [((1, 40, 72, 128), torch.bfloat16),
                                         ((3, 7, 5), torch.float32)])
def test_copy_plain_is_exact(shape, dtype):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(np.float32)).to(dtype)
    out = cuda_probes.copy(x)
    assert torch.equal(out, x) and out.dtype == x.dtype
    assert out.data_ptr() != x.data_ptr()


# ------------------------------------------------------------ conv + 4 FF
def test_conv_ffk_composition_matches_reference():
    """The bench's path at a small size: the 32x32 stride-2 pad-15 conv
    (space-to-depth, then a 16x16 VALID conv: more than 8 taps a side)
    and four pre-norm FFs (kernel 1's plain version here), against
    credit_tpu's conv2d and `_xla_ff`, f32 (1e-4 relative)."""
    rng = np.random.default_rng(1)
    cin, c = 6, 16
    x = (rng.standard_normal((1, 40, 72, cin)) * 0.3).astype(np.float32)
    kern = (rng.standard_normal((32, 32, cin, c)) * 0.02).astype(np.float32)
    prm = [np.ones(c, np.float32), np.zeros(c, np.float32),
           (rng.standard_normal((c, 4 * c)) * 0.2).astype(np.float32),
           (0.1 * rng.standard_normal(4 * c)).astype(np.float32),
           (rng.standard_normal((4 * c, c)) * 0.2).astype(np.float32),
           (0.1 * rng.standard_normal(c)).astype(np.float32)]
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(kern), None, (2, 2), 15)
    out = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(kern), None, 2, 15)
    assert out.shape == (1, 20, 36, c)
    assert _rel(out, ref) < 1e-5
    for _ in range(4):
        ref = jff._xla_ff(ref.reshape(-1, c), *map(jnp.asarray, prm)).reshape(ref.shape)
        out = cuda_ff.fused_ff(out, *map(torch.from_numpy, prm))
    assert _rel(out, ref) < 1e-4


def test_conv_ffk_xla_mode_matches_tool_composition():
    """The `xla` mode's FF (no affine, bf16 products, exact GELU) against
    the tool's jnp composition (tools/bench_conv_ffk.py:100-109), bf16."""
    rng = np.random.default_rng(2)
    c = 32
    yj, yt = _pair(rng.standard_normal((1, 6, 10, c)), "bfloat16")
    w1j, w1t = _pair(rng.standard_normal((c, 4 * c)) * 0.1, "bfloat16")
    w2j, w2t = _pair(rng.standard_normal((4 * c, c)) * 0.1, "bfloat16")
    z = yj.astype(jnp.float32)
    mu = z.mean(-1, keepdims=True)
    var = ((z - mu) ** 2).mean(-1, keepdims=True)
    z = ((z - mu) * jax.lax.rsqrt(var + 1e-5)).astype(yj.dtype)
    hdn = jax.nn.gelu(jnp.matmul(z.reshape(-1, c), w1j, preferred_element_type=yj.dtype),
                      approximate=False)
    ref = yj + jnp.matmul(hdn, w2j, preferred_element_type=yj.dtype).reshape(yj.shape)
    out = bench_conv_ffk._xla_ff(yt, w1t, w2t)
    assert out.dtype == torch.bfloat16
    assert _rel(out, ref) < 2e-2


# ------------------------------------------------------------ the benches
def test_bench_modes_and_launch_counts():
    assert len(bench_conv_ffk.MODES) == 12
    assert bench_conv_ffk.parse("pallas-t-firewall") == (True, "pallas-t")
    assert bench_conv_ffk.parse("identity-end") == (False, "identity-end")
    assert bench_conv_ffk.launches_per_call("pallas") == {"conv2d_valid": 1,
                                                          "fused_ff": 4, "copy": 0}
    assert bench_conv_ffk.launches_per_call("identity-input-firewall") == {
        "conv2d_valid": 1, "fused_ff": 0, "copy": 1}
    for bad in ("pallas-tiny", "tpu"):
        with pytest.raises(ValueError, match="pallas-tiny|unknown"):
            bench_conv_ffk.parse(bad)
    # refused before anything runs, with a clear error and exit code 2
    assert bench_conv_ffk.main(["pallas-tiny"]) == 2


def test_benches_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_conv.run(iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_conv_ffk.make("xla")


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_kernels_match_plain_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    x = torch.randn((2, 37, 45, 24), generator=g, device=cuda).to(dtype)
    k = (torch.randn((8, 8, 24, 40), generator=g, device=cuda) * 0.05).to(dtype)
    ref = cuda_conv.conv2d_valid_plain(x, k).cpu()
    for th in (5, 24, 32):
        assert _rel(cuda_probes.conv_band_dma(x, k, th).cpu(), ref) < tol
        assert _rel(cuda_probes.conv_band_halo(x, k, th).cpu(), ref) < tol
    k16 = (torch.randn((16, 16, 24, 40), generator=g, device=cuda) * 0.05).to(dtype)
    assert _rel(cuda_conv.conv2d_valid(x, k16).cpu(), cuda_conv.conv2d_valid_plain(x, k16).cpu()) < tol
    assert torch.equal(cuda_probes.copy(x), x)

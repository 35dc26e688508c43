"""Parity of the PyTorch port's backward pieces with credit_tpu: the plain
versions of kernels 4 (`fused_ff_bwd`) and 5 (`conv2d_wgrad`), the autograd
Functions of kernels 1-3 and train-mode spectral norm.

The same numpy inputs go through the JAX function (Pallas kernels run
interpreted, as credit_tpu's own tests run them on the CPU) and its port
counterpart, in f32. The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py and the `cuda`-marked test.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu.models import spectral_utils as jsu
from credit_tpu.ops import pallas_conv as jpc
from credit_tpu.ops import pallas_ff as jff
from credit_torch.convert_jax import from_jax_variables
from credit_torch.models import load_model
from credit_torch.models import spectral_utils as tsu
from credit_torch.ops import cuda_attention, cuda_conv, cuda_ff
from tests.test_torch_port_model import CONFS, _numpy_variables, _to_numpy


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(out, ref) -> float:
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-30))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# --------------------------------------------------------------- kernel 4
def _ff_args(shape, seed=0):
    rng = np.random.default_rng(seed)
    c, hid = shape[-1], 4 * shape[-1]
    return [rng.standard_normal(shape) * 0.4, rng.standard_normal(shape) * 0.3,
            rng.standard_normal(c) * 0.1 + 1.0, rng.standard_normal(c) * 0.1,
            rng.standard_normal((c, hid)) * 0.05, rng.standard_normal(hid) * 0.05,
            rng.standard_normal((hid, c)) * 0.05, rng.standard_normal(c) * 0.05]


@pytest.mark.parametrize("shape", [(296, 128), (2, 5, 12, 128)], ids=["2d", "4d"])
def test_fused_ff_bwd_plain_matches_pallas(shape):
    """C=128, hidden 512, f32. M (296, 120) is no multiple of the CUDA
    kernels' 128- or 64-row tiles. Each of dx, dg, db, dw1, db1, dw2, db2
    within 1e-5 of its max |ref|: the TPU kernel's erf is Abramowitz-Stegun
    7.1.26 (1.5e-7 absolute), the port's the exact one, and the row sums run
    in another order."""
    a = _ff_args(shape)
    ref = jff.fused_ff_bwd(*(jnp.asarray(v, jnp.float32) for v in a), interpret=True)
    out = cuda_ff.fused_ff_bwd(*(_t(v) for v in a))
    for name, o, r in zip(["dx", "dg", "db", "dw1", "db1", "dw2", "db2"], out, ref):
        assert o.dtype == torch.float32
        assert _rel(o, r) <= 1e-5, name


@pytest.mark.parametrize("post_norm", [False, True], ids=["pre_norm", "post_norm"])
def test_fused_ff_diff_matches_autograd_of_plain(post_norm):
    """The autograd Function (kernel 2 forward, kernel 4 backward) against
    torch autograd through fused_ff_plain, f32, every input's gradient, in
    both forms."""
    x, ct, *prm = (_t(v) for v in _ff_args((3, 4, 7, 32), seed=1))
    leaves = [t.clone().requires_grad_() for t in [x, *prm]]
    out = cuda_ff.fused_ff_diff(*leaves, post_norm=post_norm)
    grads = torch.autograd.grad(out, leaves, ct)
    leaves2 = [t.clone().requires_grad_() for t in [x, *prm]]
    ref = cuda_ff.fused_ff_plain(*leaves2, post_norm=post_norm)
    refs = torch.autograd.grad(ref, leaves2, ct)
    assert _rel(out, ref) <= 1e-6
    for g, r in zip(grads, refs):
        assert _rel(g, r) <= 1e-5


# --------------------------------------------------------------- kernel 5
@pytest.mark.parametrize("kh,kw,cin,cout,hp,wp", [
    (8, 8, 16, 24, 21, 19),
    (3, 3, 8, 16, 14, 18),
    (2, 2, 8, 8, 10, 12),
    (1, 1, 8, 8, 9, 11),
])
def test_conv2d_wgrad_plain_matches_pallas_and_taploop(kh, kw, cin, cout, hp, wp):
    """The shapes of credit_tpu's own wgrad test, f32: within 1e-5 of max
    |ref| (summation order only) of the Pallas kernel (interpreted) and of
    the tap-loop reference."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, hp, wp, cin)) * 0.3
    gy = rng.standard_normal((2, hp - kh + 1, wp - kw + 1, cout)) * 0.3
    out = cuda_conv.conv2d_wgrad(_t(x), _t(gy), kh, kw)
    assert out.dtype == torch.float32 and out.shape == (kh, kw, cin, cout)
    xj, gj = jnp.asarray(x, jnp.float32), jnp.asarray(gy, jnp.float32)
    assert _rel(out, jpc.conv2d_wgrad(xj, gj, kh, kw)) <= 1e-5
    assert _rel(out, jpc._taploop_gk(xj, gj, kh, kw)) <= 1e-5


@pytest.mark.parametrize("k", [2, 3, 8])
def test_conv2d_valid_diff_matches_jax_vjp(k):
    """gx (kernel 1 on the padded cotangent with the flipped, io-swapped
    kernel) and gk (kernel 5) against jax.vjp of credit_tpu's conv2d_valid,
    f32 (1e-5 of max |ref|)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((1, 15, 13, 8)) * 0.3
    kern = rng.standard_normal((k, k, 8, 12)) * 0.1
    gy = rng.standard_normal((1, 16 - k, 14 - k, 12)) * 0.3
    _, vjp = jax.vjp(jpc.conv2d_valid, jnp.asarray(x, jnp.float32), jnp.asarray(kern, jnp.float32))
    gx_ref, gk_ref = vjp(jnp.asarray(gy, jnp.float32))
    xt, kt = _t(x).requires_grad_(), _t(kern).requires_grad_()
    out = cuda_conv.conv2d_valid_diff(xt, kt)
    gx, gk = torch.autograd.grad(out, [xt, kt], _t(gy))
    assert _rel(gx, gx_ref) <= 1e-5
    assert _rel(gk, gk_ref) <= 1e-5
    # and against autograd of the plain composition; x without a gradient
    # skips gx
    xp, kp = _t(x).requires_grad_(), _t(kern).requires_grad_()
    refs = torch.autograd.grad(cuda_conv.conv2d_valid_plain(xp, kp), [xp, kp], _t(gy))
    assert _rel(gx, refs[0]) <= 1e-6 and _rel(gk, refs[1]) <= 1e-6
    before = cuda_conv.conv2d_valid.launches
    (gk2,) = torch.autograd.grad(cuda_conv.conv2d_valid_diff(_t(x), kt), [kt], _t(gy))
    assert cuda_conv.conv2d_valid.launches == before  # CPU: no kernel counted
    torch.testing.assert_close(gk2, gk)


# --------------------------------------------------------------- kernel 3
@pytest.mark.parametrize("t", [4, 25])
def test_window_attention_diff_matches_autograd_of_plain(t):
    """Kernel 3's Function: forward on the kernel, backward by autograd of
    the plain version recomputed from q, k, v and the bias (f32, 1e-6)."""
    heads, dh, nwin = 2, 16, 3
    rng = np.random.default_rng(t)
    qkv = _t(rng.standard_normal((1, nwin, t, 3 * heads * dh)))
    bias = _t(rng.standard_normal((t, t)))
    gout = _t(rng.standard_normal((1, nwin, t, heads * dh)))

    def grads(fn):
        leaf, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        q, k, v = leaf.split(heads * dh, dim=-1)
        out = fn(q, k, v, b, heads)
        return (out, *torch.autograd.grad(out, [leaf, b], gout))

    out, gqkv, gb = grads(cuda_attention.fused_window_attention_diff)
    ref, rqkv, rb = grads(cuda_attention.fused_window_attention_plain)
    assert _rel(out, ref) <= 1e-6 and _rel(gqkv, rqkv) <= 1e-6 and _rel(gb, rb) <= 1e-6


# --------------------------------------------------------------- spectral norm
@pytest.fixture(scope="module")
def tiny():
    from credit_tpu.models import load_model as jax_load_model

    conf = copy.deepcopy(CONFS["quadrant"])
    jmodel = jax_load_model(conf)
    x = np.random.default_rng(0).standard_normal(
        (1, 1, 32, 64, jmodel.base_input_channels)).astype(np.float32)
    return conf, jmodel, _numpy_variables(jmodel, x, 3), x


def test_train_mode_spectral_norm_matches_reference(tiny):
    """One train-mode forward with SN state: the output (1e-4 relative, as
    the f32 forward test) and every updated u, v (1e-5) against
    model.apply(..., train=True, mutable=["spectral"])."""
    conf, jmodel, variables, x = tiny
    ref, mut = jax.jit(lambda v, a: jmodel.apply(v, a, train=True, mutable=["spectral"]))(
        variables, jnp.asarray(x))
    port = load_model(conf, device="cpu", sn_state=True)
    port.load_state_dict(from_jax_variables(_to_numpy(variables), conf, device="cpu",
                                            fold=False))
    port.train()
    out = port(torch.from_numpy(x))
    assert _rel(out, ref) < 1e-4
    state = port.state_dict()
    spec = jax.tree_util.tree_flatten_with_path(jax.device_get(mut["spectral"]))[0]
    assert len(spec) == sum(1 for k in state if k.endswith((".u", ".v")))
    for path, leaf in spec:
        key = ".".join(p.key for p in path)
        np.testing.assert_allclose(state[key].numpy(), leaf, atol=1e-5, err_msg=key)
    # eval mode: no update, and the forward equals the folded model's
    port.eval()
    before = {k: v.clone() for k, v in port.state_dict().items() if k.endswith(".u")}
    with torch.no_grad():
        y_sn = port(torch.from_numpy(x))
    assert all(torch.equal(port.state_dict()[k], v) for k, v in before.items())
    folded = load_model(conf, device="cpu")
    folded.load_state_dict(from_jax_variables(
        {"params": _to_numpy(variables)["params"],
         "spectral": {k: v for k, v in _flat_tree(port)}}, conf, device="cpu"))
    with torch.no_grad():
        assert _rel(folded(torch.from_numpy(x)), y_sn) < 1e-5


def _flat_tree(model):
    """The model's u/v buffers as a nested spectral tree of numpy arrays."""
    tree = {}
    for k, v in model.state_dict().items():
        if k.endswith((".u", ".v")):
            node = tree
            *path, leaf = k.split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v.numpy()
    return tree.items()


def test_power_iter_spectral_matches_reference():
    """One and three power iterations, plain and scan-stacked (depth, O)
    vectors, f32 (1e-5)."""
    rng = np.random.default_rng(4)
    unit = lambda *s: (lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True))(  # noqa: E731
        rng.standard_normal(s)).astype(np.float32)
    params = {"a": {"kernel": rng.standard_normal((3, 3, 4, 6)).astype(np.float32)},
              "blocks": {"b": {"kernel": rng.standard_normal((2, 5, 7)).astype(np.float32)}}}
    spectral = {"a": {"u": unit(6), "v": unit(36)},
                "blocks": {"b": {"u": unit(2, 7), "v": unit(2, 5)}}}
    for n in (1, 3):
        ref = jax.device_get(jsu.power_iter_spectral(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, spectral), n))
        to_t = lambda d: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v)  # noqa: E731
                          for k, v in d.items()}
        out = tsu.power_iter_spectral(to_t(params), to_t(spectral), n)
        for path in (("a", "u"), ("a", "v"), ("blocks", "b", "u"), ("blocks", "b", "v")):
            o, r = out, ref
            for p in path:
                o, r = o[p], r[p]
            np.testing.assert_allclose(o.numpy(), r, atol=1e-5, err_msg=str((n, path)))

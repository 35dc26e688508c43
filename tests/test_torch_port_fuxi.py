"""Parity of the PyTorch port's FuXi slice with credit_tpu: the post-norm
mode of kernels 2 and 4 (plain versions), the 3x3/s2 conv route, the patch
conv3d, the SwinV2 masks and tables, the FuXi and standalone SwinV2
forwards (f32 and bf16, both parameter layouts) and a FuXi rollout with two
input frames.

The same numpy inputs and weights go through both packages on the CPU. The
Pallas kernels run interpreted, as credit_tpu's own tests run them; the
port's kernels run their plain PyTorch versions, which chip_smoke.py and the
`cuda`-marked test hold the CUDA kernels against on the card.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.models import swin as jswin
from credit_tpu.models.spectral_utils import fold_spectral
from credit_tpu.ops import conv as jconv
from credit_tpu.ops import pallas_conv as jpc
from credit_tpu.ops import pallas_ff as jff
from credit_tpu.rollout import make_scan_rollout as jax_scan_rollout
from credit_torch.convert_jax import from_jax_variables, init_folded, init_train
from credit_torch.data.channels import ChannelSchema
from credit_torch.models import load_model
from credit_torch.models import swin as tswin
from credit_torch.models.fuxi import Fuxi
from credit_torch.ops import conv as tconv
from credit_torch.ops import cuda_ff
from credit_torch.ops import window_attention as twa
from credit_torch.rollout import make_scan_rollout
from tests.test_fuxi_swin import FUXI_CONF, SWIN_CONF
from tests.test_torch_port_model import DATA, _bf16, _numpy_variables, _rel, _to_numpy

# the tiny config of credit_tpu's own FuXi test, and a dim-128 variant whose
# SwinV2 MLPs credit_tpu can run through its fused post-norm Pallas kernel
FUXI_128 = copy.deepcopy(FUXI_CONF)
FUXI_128["model"].update(dim=128, num_groups=8)
CONFS = {"dim32": FUXI_CONF, "dim128": FUXI_128}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


# --------------------------------------------------------------- kernels 2, 4
def _ff_args(shape, seed=0):
    rng = np.random.default_rng(seed)
    c, hid = shape[-1], 4 * shape[-1]
    return [rng.standard_normal(shape) * 0.4, rng.standard_normal(shape) * 0.3,
            rng.standard_normal(c) * 0.1 + 1.0, rng.standard_normal(c) * 0.1,
            rng.standard_normal((c, hid)) * 0.05, rng.standard_normal(hid) * 0.05,
            rng.standard_normal((hid, c)) * 0.05, rng.standard_normal(c) * 0.5]


DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# (rows, C) and (B, H, W, C) at C = 128, hidden 512; the row counts divide
# the bf16 Pallas backward's tiles (it takes dividing tiles only)
SHAPES = {"2d": (288, 128), "4d": (2, 5, 12, 128)}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_post_norm_ff_plain_matches_pallas_and_xla(shape, dt):
    """x + LN(fc2(GELU(fc1(x)))): the port's plain version against the Pallas
    kernel (interpreted) and `_xla_ff`, both with post_norm=True. f32 within
    1e-5 of max |ref| (the Pallas erf is Abramowitz-Stegun, 1.5e-7 off);
    bf16 within 2e-2 (a rounding flipped before the last cast moves an
    output by one bf16 ulp of the residual sum)."""
    tdt, jdt = DTYPES[dt]
    x, _, *prm = _ff_args(SHAPES[shape])
    out = cuda_ff.fused_ff_plain(_t(x, tdt), *(_t(p) for p in prm), post_norm=True)
    assert out.dtype == tdt
    tol = 1e-5 if dt == "f32" else 2e-2
    for ref in (jff.fused_ff(_j(x, jdt), *(_j(p) for p in prm), interpret=True, post_norm=True),
                jff._xla_ff(_j(x, jdt), *(_j(p) for p in prm), post_norm=True)):
        assert _rel(out.float().numpy(), jnp.asarray(ref, jnp.float32)) <= tol


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_post_norm_ff_bwd_plain_matches_pallas_and_vjp(shape, dt):
    """The post-norm backward (dx, dg, db, dw1, db1, dw2, db2) against the
    Pallas backward (interpreted) and, in f32, jax.vjp of `_xla_ff`: each
    output within 1e-4 (f32: summation order; b2 moves the output LN's
    statistics) or 2e-2 (bf16) of its max |ref|."""
    tdt, jdt = DTYPES[dt]
    x, ct, *prm = _ff_args(SHAPES[shape], seed=1)
    out = cuda_ff.fused_ff_bwd_plain(_t(x, tdt), _t(ct, tdt), *(_t(p) for p in prm),
                                     post_norm=True)
    refs = [jff.fused_ff_bwd(_j(x, jdt), _j(ct, jdt), *(_j(p) for p in prm), interpret=True,
                             post_norm=True)]
    if dt == "f32":
        _, vjp = jax.vjp(lambda *a: jff._xla_ff(*a, post_norm=True), _j(x), *(_j(p) for p in prm))
        refs.append(vjp(_j(ct)))
    tol = 1e-4 if dt == "f32" else 2e-2
    for ref in refs:
        for name, o, r in zip(["dx", "dg", "db", "dw1", "db1", "dw2", "db2"], out, ref):
            assert o.dtype == (tdt if name == "dx" else torch.float32), name
            assert _rel(o.float().numpy(), jnp.asarray(r, jnp.float32)) <= tol, name


def test_post_norm_ff_at_a_width_the_kernel_pads():
    """C = 192, which the bf16 CUDA kernel pads to 256: the plain forward and
    backward against `_xla_ff` and its vjp in f32 (the Pallas kernel takes
    C % 128 == 0 only), 1e-5 / 1e-4 of max |ref|."""
    x, ct, *prm = _ff_args((3, 4, 5, 192), seed=2)
    out = cuda_ff.fused_ff_plain(_t(x), *(_t(p) for p in prm), post_norm=True)
    ref, vjp = jax.vjp(lambda *a: jff._xla_ff(*a, post_norm=True), _j(x), *(_j(p) for p in prm))
    assert _rel(out.numpy(), ref) <= 1e-5
    grads = cuda_ff.fused_ff_bwd_plain(_t(x), _t(ct), *(_t(p) for p in prm), post_norm=True)
    for g, r in zip(grads, vjp(_j(ct))):
        assert _rel(g.numpy(), r) <= 1e-4


# --------------------------------------------------------------- convs
@pytest.mark.parametrize("h,w", [(12, 16), (13, 17), (12, 15)], ids=["even", "odd", "mixed"])
def test_stride2_3x3_conv_matches_reference(h, w):
    """The DownBlock's 3x3/s2/p1 conv through the zero-extended 4x4 kernel,
    space-to-depth and the 2x2 VALID conv, against credit_tpu's conv2d (XLA
    on the CPU), forward and gradients (jax.vjp), f32 (1e-5 of max |ref|)."""
    rng = np.random.default_rng(h * w)
    x = rng.standard_normal((2, h, w, 8))
    k = rng.standard_normal((3, 3, 8, 12)) * 0.2
    b = rng.standard_normal(12) * 0.1
    ref, vjp = jax.vjp(lambda a, kk: jconv.conv2d(a, kk, _j(b), stride=2, padding=1), _j(x), _j(k))
    xt, kt = _t(x).requires_grad_(), _t(k).requires_grad_()
    out = tconv.conv2d(xt, kt, _t(b), stride=2, padding=1)
    assert out.shape == ref.shape == (2, (h - 1) // 2 + 1, (w - 1) // 2 + 1, 12)
    assert _rel(out.detach().numpy(), ref) <= 1e-5
    gy = rng.standard_normal(ref.shape)
    gx, gk = torch.autograd.grad(out, [xt, kt], _t(gy))
    rx, rk = vjp(_j(gy))
    assert _rel(gx.numpy(), rx) <= 1e-5 and _rel(gk.numpy(), rk) <= 1e-5


def test_patch_conv3d_matches_reference():
    """The non-overlapping patch conv3d (stride = kernel, truncating dims the
    patch does not divide) against credit_tpu's conv3d (XLA) and its patch
    GEMM, f32; other forms raise."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 10, 13, 5))
    k = rng.standard_normal((2, 4, 4, 5, 16)) * 0.1
    b = rng.standard_normal(16) * 0.1
    out = tconv.conv3d(_t(x), _t(k), _t(b), stride=(2, 4, 4))
    ref = jconv.conv3d(_j(x), _j(k), _j(b), stride=(2, 4, 4))
    assert out.shape == ref.shape == (2, 2, 2, 3, 16)
    assert _rel(out.numpy(), ref) <= 1e-5
    gemm = jpc.patch_conv3d_gemm(_j(x[:, :, :8, :12]), _j(k)) + _j(b)
    assert _rel(out.numpy(), gemm) <= 1e-5
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tconv.conv3d(_t(x), _t(k), stride=(1, 2, 2))


# --------------------------------------------------------------- SwinV2 pieces
@pytest.mark.parametrize("h,w,ws,shift", [(8, 12, 4, 2), (14, 21, 7, 3), (105, 161, 7, 3)])
def test_shift_mask_and_position_tables_match_reference(h, w, ws, shift):
    """The shift mask exactly; the CPB table and relative index exactly
    (integers) or within f32 rounding (the log-spaced table)."""
    mask = tswin.shift_attn_mask(h, w, ws, shift)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jswin._shift_attn_mask(h, w, ws, shift)))
    np.testing.assert_array_equal(twa.relative_position_index(ws).numpy(),
                                  jswin._relative_position_index(ws))
    np.testing.assert_allclose(tswin.relative_coords_table(ws).numpy(),
                               jswin._relative_coords_table(ws), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- models
def _input(model, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (1, model.frames, model.image_height, model.image_width,
         model.base_input_channels)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CONFS))
def built(request):
    """(conf, jax model, converged variables, numpy input) per width."""
    conf = CONFS[request.param]
    model = jax_load_model(conf)
    x = _input(model)
    return conf, model, _numpy_variables(model, x, 1), x


def test_fuxi_forward_matches_reference_f32(built):
    """f32, unrolled layout: the same math in another order (1e-4 relative)."""
    conf, model, variables, x = built
    ref = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = load_model(conf, device="cpu")
    port.load_state_dict(from_jax_variables(_to_numpy(variables), conf, device="cpu"))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == ref.shape
    assert _rel(out.numpy(), ref) < 1e-4


def test_fuxi_forward_matches_reference_bf16(built):
    """bf16 weights and compute on both sides, spectral norm folded. At dim
    128 credit_tpu runs its fused post-norm MLP kernel (ff_fusion force,
    interpreted), so both sides round where the kernel does; at dim 32 its
    XLA composition rounds fc1's output and GELU's input to bf16 too, and
    the port does not. Through 2 SwinV2 blocks and 5 convs that stays within
    5e-2 of max |out|."""
    conf, model, variables, x = built
    jconf = copy.deepcopy(conf)
    jconf["model"].update(compute_dtype="bfloat16", use_spectral_norm=False, ff_fusion="force")
    jmodel = jax_load_model(jconf)
    folded = _to_numpy(_bf16(fold_spectral(variables)["params"]))
    ref = jax.jit(jmodel.apply)({"params": _bf16(folded)}, jnp.asarray(x, jnp.bfloat16))
    port = load_model(jconf, device="cpu")
    port.load_state_dict(from_jax_variables({"params": folded}, jconf, device="cpu"))
    port = port.to(torch.bfloat16)
    with torch.no_grad():
        out = port(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert _rel(out.float().numpy(), jnp.asarray(ref, jnp.float32)) < 5e-2


def test_fuxi_forward_from_scan_blocks_layout(built):
    """credit_tpu's scan_blocks FuXi (SwinV2 block pairs stacked under
    swin/blocks/{b0,b1}) with its own numpy weights, bridged into the
    unrolled port: f32, 1e-4 relative, folded and with SN state."""
    conf, _, _, x = built
    sconf = copy.deepcopy(conf)
    sconf["model"]["scan_blocks"] = True
    smodel = jax_load_model(sconf)
    variables = _numpy_variables(smodel, x, 2)
    assert set(variables["params"]["u_transformer"]["swin"]["blocks"]) == {"b0", "b1"}
    ref = jax.jit(smodel.apply)(variables, jnp.asarray(x))
    for fold in (True, False):
        port = load_model(sconf, device="cpu", sn_state=not fold)
        port.load_state_dict(from_jax_variables(_to_numpy(variables), sconf, device="cpu",
                                                fold=fold))
        with torch.no_grad():
            out = port(torch.from_numpy(x))
        assert _rel(out.numpy(), ref) < 1e-4, fold


def test_fuxi_rollout_with_two_input_frames_matches_reference(built):
    """Two steps of make_scan_rollout with history_len=2 against credit_tpu's:
    the final two-frame state and the per-step channel means, f32 (1e-4)."""
    conf, model, variables, x = built
    full = {**conf, "data": DATA}
    jschema, schema = JSchema.from_config(full), ChannelSchema.from_config(full)
    assert schema.n_input == model.base_input_channels
    jx, jstats = jax.jit(jax_scan_rollout(model, jschema, 2, history_len=2))(
        variables, jnp.asarray(x))
    port = load_model(conf, device="cpu")
    port.load_state_dict(from_jax_variables(_to_numpy(variables), conf, device="cpu"))
    tx, tstats = make_scan_rollout(port, schema, 2, history_len=2, device="cpu")(
        torch.from_numpy(x))
    assert tx.shape == x.shape and tstats.shape == (2, model.base_output_channels)
    assert _rel(tx.numpy(), jx) < 1e-4
    assert _rel(tstats.numpy(), jstats) < 1e-4


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_swin_forward_matches_reference(dt):
    """The standalone SwinV2 model (registry name `swin`): f32 within 1e-4,
    bf16 (weights and compute on both sides) within 5e-2 of max |out|."""
    conf = copy.deepcopy(SWIN_CONF)
    model = jax_load_model(conf)
    x = _input(model, seed=4)
    variables = _to_numpy(_numpy_variables(model, x, 5))
    tdt, jdt = DTYPES[dt]
    conf["model"]["compute_dtype"] = {"f32": "float32", "bf16": "bfloat16"}[dt]
    jmodel = jax_load_model(conf)
    jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), variables)
    ref = jax.jit(jmodel.apply)(jv, jnp.asarray(x, jdt))
    port = load_model(conf, device="cpu")
    port.load_state_dict(from_jax_variables(variables, conf, device="cpu"))
    port = port.to(tdt)
    with torch.no_grad():
        out = port(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    assert _rel(out.float().numpy(), jnp.asarray(ref, jnp.float32)) < (1e-4 if dt == "f32"
                                                                       else 5e-2)


def test_seeded_init_normalises_only_the_sn_convs():
    """init_folded / init_train key spectral norm off each layer: the
    Down/UpBlock convs get u/v, and init_folded divides them by
    sigma = u . (W v) (near their spectral norm after 30 power iterations);
    the cube embed, the SwinV2 Dense layers and the head keep the same draw
    undivided. logit_scale starts at log 10, q_bias and v_bias at 0."""
    conf = CONFS["dim32"]
    folded = init_folded(conf, torch.Generator().manual_seed(0), device="cpu")
    train = init_train(conf, torch.Generator().manual_seed(0), device="cpu")
    uv = sorted(k for k, _ in train.named_buffers() if k.endswith((".u", ".v")))
    convs = [f"u_transformer.{b}.{c}" for b, c in [
        ("down", "down"), ("down", "res_conv0"), ("down", "res_conv1"),
        ("up", "up"), ("up", "res_conv0"), ("up", "res_conv1")]]
    assert uv == sorted(f"{c}.{w}" for c in convs for w in "uv")
    fmods, tmods = dict(folded.named_modules()), dict(train.named_modules())
    for name, p in train.named_parameters():
        if not name.endswith("kernel"):
            continue
        path = name.rpartition(".")[0]
        got = fmods[path].kernel.detach()
        if path in convs:
            m = tmods[path]
            w = p.detach().reshape(-1, p.shape[-1]).T
            sig = torch.dot(m.u, w @ m.v)
            torch.testing.assert_close(got, p.detach() / sig, rtol=1e-5, atol=0)
            norm = torch.linalg.matrix_norm(got.double().reshape(-1, p.shape[-1]), ord=2)
            assert abs(norm.item() - 1.0) < 5e-2, path
        else:
            assert torch.equal(got, p.detach()), path
    blk = folded.u_transformer.swin.block1
    torch.testing.assert_close(blk.attn.logit_scale, torch.full((4, 1, 1), float(np.log(10.0))))
    assert not blk.attn.q_bias.any() and not blk.attn.v_bias.any()
    x = torch.randn((1, 2, 32, 64, folded.base_input_channels),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y = folded(x)
    assert torch.isfinite(y).all() and y.abs().max() < 1e3


def test_load_model_builds_fuxi_and_swin_with_routing_keys():
    """`fuxi` and `swin` build from config dicts with the reference's TPU
    routing keys (ignored), on the CPU when asked; without a card the
    default device raises."""
    conf = copy.deepcopy(FUXI_CONF)
    conf["model"].update(pallas_conv="force", ff_fusion="auto", scan_blocks=True, remat=False)
    assert load_model(conf, device="cpu").base_output_channels == 7
    sconf = copy.deepcopy(SWIN_CONF)
    sconf["model"]["remat"] = True
    assert load_model(sconf, device="cpu") is not None
    with pytest.raises(TypeError, match="unexpected"):
        Fuxi(bogus=1)
    if not torch.cuda.is_available():
        for c in (FUXI_CONF, SWIN_CONF):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                load_model(c)

"""Parity of the port's model zoo with credit_tpu: UpBlockPS, the
CrossFormer's cube embed, sub-pixel decoder and sharp skip (camulator),
the downscaling CrossFormer, the U-Net and its downscaling form, the
debugger, NextGen WXFormer, the regional WRF and dscale transformers, the
graph model, the diffusion backbones, DownscalingLoss, and every model key
credit_tpu registers building in the port.

Each credit_tpu model gets seeded numpy variables of its own tree
(`_numpy_variables`: kernels he_uniform, other parameters randomised,
spectral u/v converged), bridged into the port with `from_jax_variables`;
both run the same numpy input on the CPU in f32, credit_tpu's model under
jax.jit (its XLA composition, compiled at XLA's lowest optimisation level:
`torch_port_fixtures.jit_lowopt`) and the port's kernels as their plain
PyTorch versions.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu import losses as jlosses
from credit_tpu import registry as jregistry
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.models.graph import knn_sphere_edges as j_knn
from credit_tpu.ops.upsample import pixel_shuffle as j_pixel_shuffle
from credit_tpu.models.spectral_utils import converge_spectral, fold_spectral
from credit_torch import losses as tlosses
from credit_torch.convert_jax import from_jax_variables, init_folded, init_train
from credit_torch.models import PORTED, load_model
from credit_torch.models.graph import knn_sphere_edges, segment_softmax, segment_sum
from credit_torch.ops.upsample import icnr_kernel, pixel_shuffle
from torch_port_fixtures import jit_lowopt, two_torch_threads  # noqa: F401

# the CrossFormer family at 32x64: four stages of stride 2 down to 2x4
CF = dict(frames=1, output_frames=1, image_height=32, image_width=64, levels=2, channels=2,
          surface_channels=1, input_only_channels=1, output_only_channels=1,
          dim=[16, 32, 64, 128], depth=[1, 1, 1, 1], global_window_size=[2, 2, 2, 1],
          local_window_size=2, cross_embed_kernel_sizes=[[2, 4], [2, 4], [2, 4], [2, 4]],
          cross_embed_strides=[2, 2, 2, 2], use_spectral_norm=True, dim_head=8, interp=True)
PI = dict(image_height=32, image_width=32, patch_height=2, patch_width=2, levels=2, frames=1,
          frame_patch_size=1, channels=2, surface_channels=1, input_only_channels=1,
          output_only_channels=0, dim=32)
UN = dict(frames=1, image_height=30, image_width=60, levels=2, channels=2, surface_channels=1,
          input_only_channels=1, output_only_channels=1, encoder_dims=[8, 16, 32])

# name -> (model section, input shape (B, T, H, W, C), extra inputs' shapes)
MODELS = {
    # the cube embed: 2 frames in 2x2x2 patches, the stages at 16x32 .. 1x2
    "crossformer_cube": ({"type": "crossformer", **CF, "frames": 2, "patch_height": 2,
                          "patch_width": 2, "local_window_size": [2, 2, 2, 1],
                          "global_window_size": [2, 2, 1, 1]}, (1, 2, 32, 64, 6), ()),
    "camulator_ps": ({"type": "camulator", **CF, "upsample_with_ps": True},
                     (1, 1, 32, 64, 6), ()),
    "crossformer_downscaling": ({"type": "crossformer_downscaling", **CF,
                                 "out_image_height": 48, "out_image_width": 80},
                                (1, 1, 32, 64, 6), ()),
    "unet": ({"type": "unet", **UN, "use_spectral_norm": True}, (1, 1, 30, 60, 6), ()),
    "unet_downscaling": ({"type": "unet_downscaling", **UN, "frames": 2},
                         (1, 2, 15, 30, 6), ()),
    "debugger": ({"type": "debugger", "frames": 2, "image_height": 8, "image_width": 16,
                  "levels": 2, "channels": 2, "surface_channels": 1, "input_only_channels": 1},
                 (2, 2, 8, 16, 6), ()),
    "nextgen_wxformer": ({"type": "nextgen_wxformer", **{k: v for k, v in CF.items()
                                                         if k not in ("interp",)},
                          "frames": 2, "channels": 4, "levels": 3, "col_attn_heads": 2,
                          "num_spectral_nodes": 4}, (1, 2, 32, 64, 14), ()),
    "wrf": ({"type": "wrf", "param_interior": PI, "param_outside": dict(PI, channels=1,
                                                                         input_only_channels=0),
             "time_encode_dim": 4, "depth": 2, "num_heads": 4, "window_size": 4,
             "num_groups": 8}, (2, 1, 32, 32, 6), ((2, 1, 32, 32, 3), (2, 4))),
    # as the trainer builds and calls it: no driving-model branch
    "wrf_interior": ({"type": "wrf", "param_interior": PI, "depth": 1, "num_heads": 4,
                      "window_size": 4, "num_groups": 8, "use_spectral_norm": False},
                     (1, 1, 32, 32, 6), ()),
    "dscale": ({"type": "dscale", "image_height": 16, "image_width": 24, "out_image_height": 32,
                "out_image_width": 48, "patch_height": 2, "patch_width": 2,
                "total_input_channels": 7, "total_target_channels": 11, "time_encode_dim": 4,
                "frames": 1, "frame_patch_size": 1, "dim": 32, "depth": 2, "num_heads": 4,
                "window_size": 4, "num_groups": 8}, (1, 1, 16, 24, 7), ((1, 4),)),
    "graph": ({"type": "graph", "image_height": 8, "image_width": 16, "levels": 2,
               "channels": 2, "surface_channels": 1, "hidden_size": 16, "n_blocks": 3,
               "heads": 2, "knn": 4, "output_frames": 2}, (2, 1, 8, 16, 5), ()),
    "crossformer-diffusion": ({"type": "crossformer-diffusion", **CF},
                              (2, 1, 32, 64, 6), ((2, 1, 32, 64, 6), (2,))),
    "unet-diffusion": ({"type": "unet-diffusion", **UN}, (2, 1, 30, 60, 6),
                       ((2, 1, 30, 60, 6), (2,))),
}
# one train step's gradients are held for these
TRAINED = ("crossformer_cube", "camulator_ps", "unet", "nextgen_wxformer", "wrf", "graph",
           "crossformer-diffusion")


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def _numpy_variables(model, inputs, seed: int):
    """Variables of the JAX model's own tree (its shapes from eval_shape),
    drawn with numpy: kernels he_uniform over every axis but the last,
    norm scales 1 + 0.1 N, every other parameter (biases, the bottleneck's
    agg_w / scatter_w, the level bias) 0.1 N, spectral u/v random unit
    vectors, then converged."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)

    def draw(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            lim = np.sqrt(6.0 / np.prod(s.shape[:-1]))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "'u'" in name or "'v'" in name:
            v = rng.standard_normal(s.shape)
            return (v / np.linalg.norm(v)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return _to_numpy(converge_spectral(jax.tree_util.tree_map_with_path(draw, shapes)))


def _inputs(name: str, seed: int = 0):
    mconf, xshape, extra = MODELS[name]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(xshape).astype(np.float32)]
    for s in extra:
        arrs.append(rng.uniform(0.0, 1.0, s).astype(np.float32) if len(s) == 1
                    else rng.standard_normal(s).astype(np.float32))
    return arrs


@functools.lru_cache(maxsize=None)
def _built(name: str):
    """(conf, credit_tpu model, its numpy variables, numpy inputs)."""
    conf = {"model": copy.deepcopy(MODELS[name][0])}
    jmodel = jax_load_model(conf)
    arrs = _inputs(name)
    variables = _numpy_variables(jmodel, [jnp.asarray(a) for a in arrs], seed=1)
    return conf, jmodel, variables, arrs


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _port_call(model, arrs):
    ts = [torch.from_numpy(a) for a in arrs]
    if len(ts) == 3 and ts[2].dim() == 1:  # diffusion: (x, y_noisy, t_frac)
        return model(ts[0], y_noisy=ts[1], t_frac=ts[2])
    return model(*ts)


def _jax_call(jmodel, variables, arrs, **kw):
    a = [jnp.asarray(v) for v in arrs]
    if len(a) == 3 and a[2].ndim == 1:
        return jmodel.apply(variables, a[0], y_noisy=a[1], t_frac=a[2], **kw)
    return jmodel.apply(variables, *a, **kw)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_reference_f32(name):
    """Eval-mode forward with spectral norm folded, f32: 1e-4 of max |ref|
    (the same math in another summation order, through up to ~20 layers;
    readings 1e-7 to 2e-6)."""
    conf, jmodel, variables, arrs = _built(name)
    ref = jit_lowopt(lambda v, *a: _jax_call(jmodel, v, a))(variables, *arrs)
    port = load_model(conf, device="cpu")
    port.load_state_dict(from_jax_variables(variables, conf, device="cpu"))
    with torch.no_grad():
        out = _port_call(port, arrs)
    assert _rel(out.numpy(), ref) < 1e-4, name


@pytest.mark.parametrize("name", TRAINED)
def test_train_gradients_match_reference(name):
    """Train mode (one spectral-norm power iteration per forward) through
    an MSE loss: the loss within 1e-5 relative, each parameter's gradient
    within 1e-4 of its largest, where a parameter's largest counts as at
    least 1e-2 of the model's (some true gradients are zero: the first
    graph gate's z_x / r_x, a DPB output bias), and the updated u/v within
    1e-5."""
    conf, jmodel, variables, arrs = _built(name)
    mconf = MODELS[name][0]
    rng = np.random.default_rng(9)
    ref_fwd = jax.eval_shape(lambda v, *a: _jax_call(jmodel, v, a), variables, *arrs)
    target = rng.standard_normal(ref_fwd.shape).astype(np.float32)

    def jloss(params):
        y, upd = _jax_call(jmodel, {"params": params, "spectral": variables.get("spectral", {})},
                           arrs, train=True, mutable=["spectral"])
        return jnp.mean((y - target) ** 2), upd

    (jl, jupd), jg = jit_lowopt(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    port = load_model(conf, device="cpu", sn_state=True)
    port.load_state_dict(from_jax_variables(variables, conf, device="cpu", fold=False))
    port.train()
    loss = torch.mean((_port_call(port, arrs) - torch.from_numpy(target)) ** 2)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl)), name
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(_to_numpy(jg))
    # a parameter that does not reach the output has no .grad (the first
    # graph gate's z_x and r_x); jax.grad gives it zeros
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in port.named_parameters()}
    assert set(flat) == set(grads)
    gmax = max(np.abs(v).max() for v in flat.values())
    for k, ref in flat.items():
        scale = max(np.abs(ref).max(), 1e-2 * gmax)
        assert np.abs(grads[k].numpy() - ref).max() <= 1e-4 * scale, (name, k)
    flat.clear()
    walk(_to_numpy(jupd.get("spectral", {})))
    state = port.state_dict()
    assert bool(flat) == bool(mconf.get("use_spectral_norm", mconf["type"] not in
                                        ("unet", "unet-diffusion", "graph", "debugger")))
    for k, ref in flat.items():
        np.testing.assert_allclose(state[k].numpy(), ref, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["camulator_ps", "nextgen_wxformer", "crossformer-diffusion",
                                  "wrf"])
def test_bf16_forward_is_bounded(name):
    """bf16 weights and compute on both sides, spectral norm folded: within
    5e-2 of max |out| as the CrossFormer's test holds it (the routes round
    at different points)."""
    conf, jmodel, variables, arrs = _built(name)
    jconf = copy.deepcopy(conf)
    jconf["model"]["compute_dtype"] = "bfloat16"
    jconf["model"]["use_spectral_norm"] = False
    jm = jax_load_model(jconf)
    folded = {"params": _to_numpy(fold_spectral(variables)["params"])}
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), folded)
    ref = jit_lowopt(lambda v, *a: _jax_call(jm, v, a))(bf, *[a for a in arrs])
    port = load_model(jconf, device="cpu")
    port.load_state_dict(from_jax_variables(folded, jconf, device="cpu"))
    port = port.to(torch.bfloat16)
    with torch.no_grad():
        out = _port_call(port, arrs)
    assert _rel(out.float().numpy(), jnp.asarray(ref, jnp.float32)) < 5e-2, name


# ------------------------------------------------------------- registry
FUXI = {"type": "fuxi", "image_height": 32, "image_width": 64, "patch_height": 4,
        "patch_width": 4, "levels": 2, "frames": 2, "frame_patch_size": 2, "dim": 32,
        "num_groups": 8, "channels": 2, "surface_channels": 2, "input_only_channels": 1,
        "num_heads": 4, "depth": 2, "window_size": 4}


def test_every_registered_model_builds():
    """Every model key credit_tpu registers (17) is ported and builds
    through load_model, with the parameter names and shapes of credit_tpu's
    tree for the same config."""
    jax_load_model({"model": {"type": "debugger"}})  # registers every model module
    keys = set(jregistry._REGISTRIES["model"])
    assert len(keys) == 17 and keys == set(PORTED)
    confs = {m[0]["type"]: m[0] for m in MODELS.values()}
    confs.update({"crossformer": CF, "wxformer": CF, "crossformer-ensemble": CF,
                  "crossformer-style": CF, "fuxi": FUXI, "swin": {
                      "image_height": 16, "image_width": 32, "patch_height": 2,
                      "patch_width": 2, "levels": 2, "channels": 2, "surface_channels": 1,
                      "embed_dim": 16, "depth": 2, "num_heads": 2, "window_size": 4}})
    for key in sorted(keys):
        conf = {"model": {**confs[key], "type": key}}
        model = load_model(conf, device="meta")
        assert sum(p.numel() for p in model.parameters()) > 0, key


# ------------------------------------------------------------- pieces
def test_pixel_shuffle_and_icnr_kernel():
    """pixel_shuffle is credit_tpu's (torch's c*r*r + i*r + j channel
    order), bitwise; the ICNR kernel repeats each of its cout sub-kernels
    r^2 times in a row, with he_normal's spread (std sqrt(2 / fan_in))."""
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 12)).astype(np.float32)
    np.testing.assert_array_equal(pixel_shuffle(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(j_pixel_shuffle(jnp.asarray(x), 2)))
    k = icnr_kernel((3, 3, 64, 32 * 4), 2, torch.Generator().manual_seed(0))
    groups = k.reshape(3, 3, 64, 32, 4)
    assert torch.equal(groups, groups[..., :1].expand_as(groups))
    assert abs(groups[..., 0].std().item() / (2.0 / (9 * 64)) ** 0.5 - 1.0) < 0.05


def test_knn_edges_and_segment_ops_match_reference():
    """The kNN edges are credit_tpu's, in order; the segment softmax and
    sum against jax.ops' on a ragged edge list (1e-6)."""
    lat = np.linspace(90.0, -90.0, 9)
    lon = np.linspace(0.0, 360.0, 18, endpoint=False)
    src, dst = knn_sphere_edges(lat, lon, 5)
    jsrc, jdst = j_knn(lat, lon, 5)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    from credit_tpu.models.graph import segment_softmax as j_softmax

    rng = np.random.default_rng(3)
    seg = np.sort(rng.integers(0, 7, 40)).astype(np.int32)
    seg[:7] = np.arange(7)  # every segment non-empty
    logits = rng.standard_normal((40, 3)).astype(np.float32) * 3
    ref = np.asarray(j_softmax(jnp.asarray(logits), jnp.asarray(seg), 7))
    ts = torch.from_numpy(seg.astype(np.int64))
    out = segment_softmax(torch.from_numpy(logits)[None], ts, 7)[0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    sums = segment_sum(torch.from_numpy(logits)[None], ts, 7)[0]
    np.testing.assert_allclose(sums.numpy(), np.asarray(jax.ops.segment_sum(
        jnp.asarray(logits), jnp.asarray(seg), 7)), rtol=0, atol=1e-5)


def test_seeded_initialisation_of_the_new_models():
    """init_train / init_folded seed every randomly initialised parameter:
    NextGen's agg_w / scatter_w as N(0, 1/N) and N(0, 1/K) (they are not
    kernels), the sub-pixel convs ICNR; camulator's sharp conv stays zero
    with no u/v (credit_tpu's init: tests/test_variants.py), and at init
    camulator equals the CrossFormer of the same draws."""
    conf = {"model": MODELS["nextgen_wxformer"][0]}
    model = init_train(conf, torch.Generator().manual_seed(0), device="cpu")
    bn = model.spectral_bottleneck
    assert abs(bn.agg_w.std().item() * bn.n_nodes ** 0.5 - 1.0) < 0.15
    assert abs(bn.scatter_w.std().item() * 4 ** 0.5 - 1.0) < 0.15
    k = model.up4_ps_conv.kernel.reshape(3, 3, -1, model.base_output_channels, 4)
    assert torch.equal(k, k[..., :1].expand_as(k)) and model.up4_ps_conv.u is not None
    cam = {"model": MODELS["camulator_ps"][0]}
    m = init_train(cam, torch.Generator().manual_seed(0), device="cpu")
    assert torch.count_nonzero(m.sharp.kernel) == 0 and m.sharp.u is None
    assert m.up_block1.sharp.u is not None and m.up_block1.sharp.kernel.abs().max() > 0
    x = torch.randn((1, 1, 32, 64, 6), generator=torch.Generator().manual_seed(1))
    plain = {"model": {**cam["model"], "type": "crossformer"}}
    with torch.no_grad():
        y = init_folded(cam, torch.Generator().manual_seed(0), device="cpu")(x)
        y0 = init_folded(plain, torch.Generator().manual_seed(0), device="cpu")(x)
    assert torch.isfinite(y).all() and torch.equal(y, y0)


# ------------------------------------------------------------- losses
@pytest.mark.parametrize("train_loss", ["mse", "almost-fair-crps"])
def test_downscaling_loss_matches_reference(train_loss):
    """Configs with data.datasets take DownscalingLoss: no latitude weights
    (asking for them warns), validation L1 unless training is CRPS-family;
    train and validation values against credit_tpu's (1e-6 relative)."""
    conf = {"data": {"datasets": {}}, "loss": {"training_loss": train_loss,
                                                "use_latitude_weights": True}}

    class Grid:
        def coslat_weights(self):
            return np.linspace(0.5, 1.5, 6).astype(np.float32)

    rng = np.random.default_rng(4)
    t = rng.standard_normal((2, 1, 6, 8, 3)).astype(np.float32)
    p = rng.standard_normal((2, 3, 1, 6, 8, 3) if train_loss != "mse"
                            else (2, 1, 6, 8, 3)).astype(np.float32)
    for validation in (False, True):
        with pytest.warns(UserWarning, match="latitude"):
            tl = tlosses.WeightedLoss.from_config(conf, Grid(), validation=validation)
        jl = jlosses.WeightedLoss.from_config(conf, Grid(), validation=validation)
        assert isinstance(tl, tlosses.DownscalingLoss) and tl.lat_weights is None
        assert tl.base_name == jl.base_name == (
            "mae" if validation and train_loss == "mse" else train_loss)
        np.testing.assert_allclose(float(tl(torch.from_numpy(t), torch.from_numpy(p))),
                                   float(jl(jnp.asarray(t), jnp.asarray(p))), rtol=1e-6)

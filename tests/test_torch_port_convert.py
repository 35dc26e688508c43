"""Parity of the port's checkpoint paths with credit_tpu's: the published
checkpoints' manifests and their synthesized state dicts (manifests.py),
CREDIT state dicts converted into the port (convert_torch.py) tensor by
tensor and through the f32 forward, the transposed convs' kernels and u/v
where a kernel has as many inputs as outputs, and a credit_tpu (orbax)
checkpoint read with tensorstore (convert_jax.read_orbax_checkpoint) and
rolled out by the port against credit_tpu's rollout of it.

CREDIT state dicts for the tiny models are built from credit_tpu's own
variables through credit_tpu's path rules (`credit_state_dict`,
`fuxi_state_dict`), each layer in CREDIT's layout: OIHW convs, (I, O, kh,
kw) transposed convs, 1x1 convs and Linear weights, channel LayerNorms as
g/b, spectral norm as weight_orig/weight_u/weight_v with v in torch's
column order.
"""

import copy
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from credit_tpu import convert_torch as jct
from credit_tpu import manifests as jmanifests
from credit_tpu.applications import experiment as jexperiment
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.models.spectral_utils import converge_spectral
from credit_tpu.trainers import trainer as jtrainer
from credit_torch import convert_torch, manifests
from credit_torch.applications import run_rollout
from credit_torch.applications.experiment import _inference_model
from credit_torch.convert_jax import from_jax_variables, read_orbax_checkpoint
from credit_torch.models import load_model
from credit_torch.ops.conv import conv_transpose2d
from tests.test_fuxi_swin import FUXI_CONF
from tests.test_torch_port_fit import _jstate, env  # noqa: F401 (env is a fixture)
from tests.test_torch_port_model import CONFS, _numpy_variables, _rel, _to_numpy
from tests.test_torch_port_rollout_app import _rollout_conf
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

_TRANSPOSED = re.compile(r"^(up_block\d/up|up_block4)$")
# a tiny CrossFormer whose last transposed conv takes as many channels as
# it gives (8 + 64 // 8 = 16 in, 2 x 6 + 3 + 1 = 16 out), which credit_tpu's
# shape test cannot tell from a conv
SQUARE = copy.deepcopy(CONFS["padded"])
SQUARE["model"].update(dim=[8, 16, 32, 64], dim_head=8, channels=6, surface_channels=3,
                       output_only_channels=1)


def _torch_v(v, kernel):
    """HWIO's flat (kh, kw, I) spectral v in torch's (I, kh, kw) order."""
    if kernel.ndim == 4:
        kh, kw, i = kernel.shape[:3]
        return v.reshape(kh, kw, i).transpose(2, 0, 1).reshape(-1)
    return v


def credit_state_dict(variables):
    """A CREDIT CrossFormer state dict of credit_tpu's variables."""
    sd = {}

    def walk(ptree, stree, path):
        leaves = {k: np.asarray(v) for k, v in ptree.items() if not isinstance(v, dict)}
        if leaves:
            ref = jct._map_path(path)
            assert ref is not None, path
            channel_ln = path.endswith("/norm") and "dpb" not in path
            for leaf, a in leaves.items():
                if leaf == "kernel":
                    if a.ndim == 4:
                        w = a.transpose(2, 3, 0, 1) if _TRANSPOSED.match(path) \
                            else a.transpose(3, 2, 0, 1)
                    else:  # Linear in the position bias, 1x1 convs elsewhere
                        w = a.T if "dpb" in path else a.T[:, :, None, None]
                    if "u" in stree:
                        sd[f"{ref}.weight_orig"] = w
                        sd[f"{ref}.weight_u"] = np.asarray(stree["u"])
                        sd[f"{ref}.weight_v"] = _torch_v(np.asarray(stree["v"]), a)
                    else:
                        sd[f"{ref}.weight"] = w
                elif leaf == "scale":
                    sd[f"{ref}.g" if channel_ln else f"{ref}.weight"] = \
                        a.reshape(1, -1, 1, 1) if channel_ln else a
                elif leaf == "bias":
                    sd[f"{ref}.b" if channel_ln else f"{ref}.bias"] = \
                        a.reshape(1, -1, 1, 1) if channel_ln else a
            return
        for k, sub in ptree.items():
            walk(sub, stree.get(k, {}), f"{path}/{k}" if path else k)

    walk(variables["params"], variables["spectral"], "")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _sn_triple(sd, ref, w, rng):
    """weight_orig w with a u, v whose sigma is |W v| > 0 (so the folded
    weights stay bounded)."""
    w2d = w.reshape(w.shape[0], -1)
    v = rng.standard_normal(w2d.shape[1])
    v /= np.linalg.norm(v)
    u = w2d @ v
    u /= np.linalg.norm(u)
    sd[f"{ref}.weight_orig"], sd[f"{ref}.weight_u"], sd[f"{ref}.weight_v"] = w, u, v


def fuxi_state_dict(variables, seed=0):
    """A CREDIT FuXi state dict of credit_tpu's variables, the inverse of
    credit_tpu's convert_fuxi: spectral norm on the Down/UpBlock convs (u/v
    from the variables), on qkv (raw at eval, timm's quirk) and on the
    folded dense layers (u/v drawn)."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray, variables["params"])
    s = jax.tree_util.tree_map(np.asarray, variables["spectral"])
    sd = {"cube_embedding.proj.weight": p["cube_embedding"]["kernel"].transpose(4, 3, 0, 1, 2),
          "cube_embedding.proj.bias": p["cube_embedding"]["bias"]}

    def norm(ref, node):
        sd[f"{ref}.weight"], sd[f"{ref}.bias"] = node["scale"], node["bias"]

    def sn_conv(ref, node, snode, transposed):
        k = node["kernel"]
        sd[f"{ref}.weight_orig"] = k.transpose(2, 3, 0, 1) if transposed else k.transpose(3, 2, 0, 1)
        sd[f"{ref}.bias"] = node["bias"]
        sd[f"{ref}.weight_u"] = snode["u"]
        sd[f"{ref}.weight_v"] = _torch_v(snode["v"], k)

    def dense(ref, node, bias=True):
        _sn_triple(sd, ref, node["kernel"].T, rng)
        if bias:
            sd[f"{ref}.bias"] = node["bias"]

    norm("cube_embedding.norm", p["cube_embedding"]["norm"])
    for blk in ("down", "up"):
        node, snode = p["u_transformer"][blk], s["u_transformer"][blk]
        sn_conv(f"u_transformer.{blk}.conv", node[blk], snode[blk], blk == "up")
        for r in range(2):
            sn_conv(f"u_transformer.{blk}.b.{3 * r}", node[f"res_conv{r}"],
                    snode[f"res_conv{r}"], False)
            norm(f"u_transformer.{blk}.b.{3 * r + 1}", node[f"res_gn{r}"])
    swin = p["u_transformer"]["swin"]
    for i in range(len(swin)):
        b, ref = swin[f"block{i}"], f"u_transformer.layer.blocks.{i}"
        _sn_triple(sd, f"{ref}.attn.qkv", b["attn"]["qkv"]["kernel"].T, rng)
        for name in ("q_bias", "v_bias", "logit_scale"):
            sd[f"{ref}.attn.{name}"] = b["attn"][name]
        dense(f"{ref}.attn.cpb_mlp.0", b["attn"]["cpb_fc1"])
        dense(f"{ref}.attn.cpb_mlp.2", b["attn"]["cpb_fc2"], bias=False)
        dense(f"{ref}.attn.proj", b["attn"]["proj"])
        norm(f"{ref}.norm1", b["norm1"])
        norm(f"{ref}.norm2", b["norm2"])
        dense(f"{ref}.mlp.fc1", b["mlp_fc1"])
        dense(f"{ref}.mlp.fc2", b["mlp_fc2"])
        sd[f"{ref}.attn.relative_position_index"] = np.zeros(4)  # buffers CREDIT saves
    dense("fc", p["fc"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _template(jmodel, x):
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x))
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)


def _flat(variables):
    out = {}
    for coll in ("params", "spectral"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables[coll])[0]:
            out[".".join(str(k.key) for k in path)] = np.asarray(leaf)
    return out


# --------------------------------------------------------------- manifests
@pytest.fixture(scope="module")
def synthesized():
    return {}


def _synth(cache, name):
    if name not in cache:
        cache[name] = manifests.synthesize_state_dict(name)
    return cache[name]


def test_manifests_match_reference():
    assert manifests.available() == jmanifests.available() == ["fuxi_6h", "wxformer_6h"]
    assert manifests.MANIFEST_MODEL_CONF == jmanifests.MANIFEST_MODEL_CONF
    for name in manifests.available():
        assert manifests.load_manifest(name) == jmanifests.load_manifest(name)
    wx = manifests.load_manifest("wxformer_6h")
    assert len(wx) == 1244 and abs(sum(int(np.prod(s)) for s in wx.values()) / 1e6 - 124.79) < 0.01
    fx = manifests.load_manifest("fuxi_6h")
    assert len(fx) == 504 and abs(sum(int(np.prod(s)) for s in fx.values()) / 1e6 - 261.1) < 0.05
    with pytest.raises(KeyError, match="available"):
        manifests.load_manifest("wxformer_1h")


@pytest.mark.parametrize("name", ["wxformer_6h", "fuxi_6h"])
def test_synthesized_state_dict_is_the_reference_bitwise(synthesized, name):
    sd, want = _synth(synthesized, name), jmanifests.synthesize_state_dict(name, seed=0)
    assert list(sd) == list(want)
    for k in want:
        assert sd[k].dtype == want[k].dtype and torch.equal(sd[k], want[k]), k
    other = manifests.synthesize_state_dict("fuxi_6h", seed=1) if name == "fuxi_6h" else None
    if other is not None:
        assert not torch.equal(other["fc.bias"], sd["fc.bias"])


@pytest.mark.parametrize("name", ["wxformer_6h", "fuxi_6h"])
def test_manifest_converts_like_the_reference(synthesized, name):
    """The published layout at full width: strict into the port's model
    (every key, every shape), each tensor bitwise credit_tpu's converted
    variable, FuXi's sigma-folded kernels within 1e-6 relative; the
    decoder's transposed convs are (kh, kw, I, O) of CREDIT's (I, O, kh, kw)
    with v in HWIO order."""
    conf = {"model": dict(manifests.MANIFEST_MODEL_CONF[name])}
    sd = _synth(synthesized, name)
    port = convert_torch.convert_checkpoint(sd, conf)
    load_model(conf, device="meta", sn_state=True).load_state_dict(port, assign=True)
    mconf = conf["model"]
    jmodel = jax_load_model(conf)
    x = np.zeros((1, mconf["frames"], mconf["image_height"], mconf["image_width"], 74),
                 np.float32)
    convert = jct.convert_fuxi if name == "fuxi_6h" else jct.convert_crossformer
    want = _flat(convert(sd, _template(jmodel, x)))
    assert sorted(port) == sorted(want)
    folded = re.compile(r"(cpb_fc[12]|proj|mlp_fc[12]|^fc)\.kernel$")
    for k, w in want.items():
        got = port[k].numpy()
        if name == "fuxi_6h" and folded.search(k):
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=0, err_msg=k)
        else:
            assert got.dtype == np.float32 and np.array_equal(got, w), k
    if name == "wxformer_6h":
        for i in range(1, 4):
            w = sd[f"up_block{i}.conv.weight_orig"].numpy()
            assert np.array_equal(port[f"up_block{i}.up.kernel"].numpy(), w.transpose(2, 3, 0, 1))
            v = sd[f"up_block{i}.conv.weight_v"].numpy()
            assert np.array_equal(port[f"up_block{i}.up.v"].numpy(),
                                  v.reshape(w.shape[0], 2, 2).transpose(1, 2, 0).reshape(-1))
        assert port["up_block4.kernel"].shape == (4, 4, 256, 71)


def test_conversion_refuses_unknown_and_missing_keys(synthesized):
    conf = {"model": dict(manifests.MANIFEST_MODEL_CONF["fuxi_6h"])}
    sd = dict(_synth(synthesized, "fuxi_6h"))
    with pytest.raises(KeyError, match="unconsumed"):
        convert_torch.convert_fuxi({**sd, "extra.weight": torch.zeros(3)}, conf)
    wx = {"model": dict(manifests.MANIFEST_MODEL_CONF["wxformer_6h"])}
    sd = dict(_synth(synthesized, "wxformer_6h"))
    sd.pop("layers.2.1.layers.3.1.layers.4.bias")
    with pytest.raises(KeyError, match="unmapped"):
        convert_torch.convert_crossformer(sd, wx)
    lenient = convert_torch.convert_crossformer(sd, wx, strict=False)
    assert not lenient["transformer2.short_ff3.fc2.bias"].any()


# --------------------------------------------------------------- tiny forwards
@pytest.mark.parametrize("which", ["padded", "quadrant"])
def test_tiny_crossformer_state_dict_forward_matches_reference(which):
    """A tiny CrossFormer's CREDIT state dict through both converters: the
    same tensors bitwise, then each side's inference model (u/v converged,
    credit_tpu's apply; the port's fold) on the same input within the f32
    tolerance of test_torch_port_model.py (1e-4 of max |out|)."""
    conf = CONFS[which]
    jmodel = jax_load_model(conf)
    x = np.random.default_rng(0).standard_normal(
        (1, 1, 32, 64, jmodel.base_input_channels)).astype(np.float32)
    sd = credit_state_dict(_to_numpy(_numpy_variables(jmodel, x, 4)))
    jvars = jct.convert_crossformer(sd, _template(jmodel, x))
    port = convert_torch.convert_crossformer(sd, conf)
    want = _flat(jvars)
    assert sorted(port) == sorted(want)
    assert all(np.array_equal(port[k].numpy(), w) for k, w in want.items())
    ref = jax.jit(jmodel.apply)(converge_spectral(jvars), jnp.asarray(x))
    model = _inference_model(conf, port, torch.device("cpu"))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert _rel(out.numpy(), ref) < 1e-4


def test_tiny_fuxi_state_dict_forward_matches_reference():
    conf = FUXI_CONF
    jmodel = jax_load_model(conf)
    x = np.random.default_rng(1).standard_normal(
        (1, 2, 32, 64, jmodel.base_input_channels)).astype(np.float32)
    sd = fuxi_state_dict(_to_numpy(_numpy_variables(jmodel, x, 5)))
    jvars = jct.convert_fuxi(sd, _template(jmodel, x))
    port = convert_torch.convert_fuxi(sd, conf)
    want = _flat(jvars)
    assert sorted(port) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(port[k].numpy(), w, rtol=1e-6, atol=0, err_msg=k)
    ref = jax.jit(jmodel.apply)(converge_spectral(jvars), jnp.asarray(x))
    model = _inference_model(conf, port, torch.device("cpu"))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert _rel(out.numpy(), ref) < 1e-4


def test_lenient_conversion_starts_unwritten_leaves_from_the_seeded_init():
    """A tiny CrossFormer state dict without one layer's weight_u / weight_v:
    strict conversion refuses it; lenient conversion takes that layer's u, v
    from the port's seeded init (init_train: converged, non-zero), as
    credit_tpu's convert-checkpoint keeps model.init's, so the folded model
    rolls out finite (zeros folded to a sigma of 0), within 1e-3 of max
    |out| of the whole state dict's: both fold after 30 power iterations,
    which from other start vectors leave that layer's sigma a little apart
    (2.8e-4 of max |out| over 2 steps here)."""
    from credit_torch.convert_jax import init_train
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.rollout import make_scan_rollout

    conf = {**CONFS["padded"], "data": {"source": {"ERA5": {
        "levels": [0.0, 1.0],
        "variables": {"prognostic": {"vars_3D": ["U", "T"], "vars_2D": ["SP", "T2M"]},
                      "dynamic_forcing": {"vars_2D": ["TISR"]}}}}}}
    jmodel = jax_load_model(conf)
    x = np.random.default_rng(3).standard_normal(
        (1, 1, 32, 64, jmodel.base_input_channels)).astype(np.float32)
    sd = credit_state_dict(_to_numpy(_numpy_variables(jmodel, x, 7)))
    ref = next(k[:-len(".weight_u")] for k in sd if k.endswith(".weight_u"))
    cut = {k: v for k, v in sd.items() if k not in (f"{ref}.weight_u", f"{ref}.weight_v")}
    with pytest.raises(KeyError, match="unmapped"):
        convert_torch.convert_crossformer(cut, conf)
    whole = convert_torch.convert_crossformer(sd, conf)
    lenient = convert_torch.convert_crossformer(cut, conf, strict=False)
    init = init_train(conf, torch.Generator().manual_seed(0), device="cpu").state_dict()
    filled = sorted(k for k in lenient if not torch.equal(lenient[k], whole[k]))
    assert len(filled) == 2 and all(k.rsplit(".", 1)[1] in ("u", "v") for k in filled)
    for k in filled:
        assert lenient[k].abs().max() > 0 and torch.equal(lenient[k], init[k])
    schema = ChannelSchema.from_config(conf)
    x0 = torch.from_numpy(x)
    outs = []
    for tensors in (whole, lenient):
        run = make_scan_rollout(_inference_model(conf, tensors, torch.device("cpu")), schema, 2,
                                device="cpu")
        final, stats = run(x0)
        assert torch.isfinite(final).all() and torch.isfinite(stats).all()
        outs.append(final.numpy())
    assert _rel(outs[1], outs[0]) < 1e-3


def test_square_transposed_conv_takes_the_transpose():
    """up_block4 of SQUARE takes 16 channels and gives 16: credit_tpu's
    converter takes the conv transpose there and swaps I and O; the port
    takes the transposed conv's, so its conv_transpose2d gives
    F.conv_transpose2d of the CREDIT weight, and credit_tpu's kernel does
    not. Every other tensor, u and v included, is credit_tpu's bitwise."""
    jmodel = jax_load_model(SQUARE)
    x = np.zeros((1, 1, 32, 64, jmodel.base_input_channels), np.float32)
    sd = credit_state_dict(_to_numpy(_numpy_variables(jmodel, x, 6)))
    w = sd["up_block4.weight_orig"].numpy()
    assert w.shape == (16, 16, 4, 4)
    port = convert_torch.convert_crossformer(sd, SQUARE)
    want = _flat(jct.convert_crossformer(sd, _template(jmodel, x)))
    assert np.array_equal(port["up_block4.kernel"].numpy(), w.transpose(2, 3, 0, 1))
    assert np.array_equal(want["up_block4.kernel"], w.transpose(2, 3, 1, 0))
    assert np.array_equal(port["up_block4.v"].numpy(), want["up_block4.v"])
    assert all(np.array_equal(port[k].numpy(), v) for k, v in want.items()
               if k != "up_block4.kernel")
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 16, 5, 6)).astype(np.float32))
    ref = F.conv_transpose2d(z, torch.from_numpy(w), stride=2, padding=1)
    nhwc = z.permute(0, 2, 3, 1)
    got = conv_transpose2d(nhwc, port["up_block4.kernel"], None, 2, 1).permute(0, 3, 1, 2)
    theirs = conv_transpose2d(nhwc, torch.from_numpy(want["up_block4.kernel"]), None, 2, 1)
    assert _rel(got.numpy(), ref.numpy()) < 1e-5
    assert _rel(theirs.permute(0, 3, 1, 2).numpy(), ref.numpy()) > 0.1


# --------------------------------------------------------------- orbax
def test_orbax_checkpoint_rolls_out_like_the_reference(env, tmp_path, monkeypatch):
    """A credit_tpu checkpoint as its convert-checkpoint writes it (orbax
    StandardCheckpointer: params, spectral, step) in save_loc/checkpoint:
    the port reads it with tensorstore, no jax or orbax (the trees bitwise),
    and run_rollout writes the files credit_tpu's run_rollout writes from
    the same checkpoint, within 1e-5 of each variable's maximum by
    credit_tpu's diff_rollout. credit_tpu's Trainer.init_state is the
    seeded numpy state of test_torch_port_fit.py (its eager flax init of
    the tiny CrossFormer takes ~60 s); load_checkpoint replaces its
    weights with the checkpoint's."""
    import orbax.checkpoint as ocp

    variables = env["variables"]
    moved = jax.tree_util.tree_map(lambda a: (a * 1.05).astype(np.float32), variables["params"])
    jconf = _rollout_conf(env, tmp_path / "jax", tmp_path / "jax_out")
    conf = _rollout_conf(env, tmp_path / "port", tmp_path / "port_out")
    payload = {"params": moved, "spectral": variables["spectral"], "step": np.zeros((), "int32")}
    for c in (jconf, conf):
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.abspath(os.path.join(c["save_loc"], "checkpoint")), payload,
                   force=True)
        ckptr.wait_until_finished()
    read = read_orbax_checkpoint(os.path.join(conf["save_loc"], "checkpoint"))
    assert sorted(read) == ["params", "spectral", "step"] and int(read["step"]) == 0
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
                           read["params"], moved)
    ported = from_jax_variables(read, conf, device="cpu", fold=False)
    assert set(ported) == set(load_model(conf, device="meta", sn_state=True).state_dict())
    monkeypatch.setattr(jtrainer.Trainer, "init_state",
                        lambda self, rng: _jstate(variables, None))
    jpaths = jexperiment.run_rollout(jconf)
    paths = run_rollout(conf, device="cpu")
    assert sorted(os.path.relpath(p, tmp_path / "port_out") for p in paths) == sorted(
        os.path.relpath(p, tmp_path / "jax_out") for p in jpaths)
    report = jexperiment.diff_rollout(paths, str(tmp_path / "jax_out"), rtol=1e-5, atol=1e-5)
    assert len(report) == 4 and all(r["ok"] for r in report), report
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        read_orbax_checkpoint(str(tmp_path))

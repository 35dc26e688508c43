"""CREDIT (PyTorch) checkpoint -> the port's parameters (port of
credit_tpu/convert_torch.py).

Converts CREDIT WXFormer/CrossFormer and FuXi state dicts, the published
HuggingFace wxformer_6h / fuxi_6h weights among them (CREDIT README.md:62-66,
credit/models/wxformer/crossformer.py module tree), into the port's state:
the flax parameter paths joined with dots, in credit_tpu's layouts
(`convert_jax.expected_state`), and each spectrally normalised layer's u, v
beside its kernel (`cel0.conv0.u`):

  - Conv2d OIHW -> HWIO; ConvTranspose2d (I,O,kh,kw) -> (kh,kw,I,O)
  - 1x1 convs -> dense (I,O); Linear (O,I) -> (I,O); Conv3d -> DHWIO
  - channel LayerNorm g/b (1,C,1,1) -> scale/bias (C,)
  - spectral-norm weight_orig/weight_u/weight_v -> kernel + u/v, v
    re-permuted from torch's (I,kh,kw) column order to HWIO's (kh,kw,I)

The result loads into `load_model(conf, sn_state=True)` (the training
model); `applications.experiment._inference_model` folds it for rollouts.
credit_tpu picks a conv kernel's transpose by which one fits the target
shape, so a transposed conv with as many inputs as outputs takes the conv
branch and swaps them; the port takes the transpose of the port module's
kind (ConvTranspose). No published checkpoint has such a layer.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

# the port's path prefix (joined with /) -> CREDIT key prefix
_RULES = [
    (re.compile(r"^cel(\d+)/conv(\d+)$"), r"layers.\1.0.convs.\2"),
    (re.compile(r"^transformer(\d+)/short_attn(\d+)$"), r"layers.\1.1.layers.\2.0"),
    (re.compile(r"^transformer(\d+)/short_ff(\d+)$"), r"layers.\1.1.layers.\2.1"),
    (re.compile(r"^transformer(\d+)/long_attn(\d+)$"), r"layers.\1.1.layers.\2.2"),
    (re.compile(r"^transformer(\d+)/long_ff(\d+)$"), r"layers.\1.1.layers.\2.3"),
    (re.compile(r"^up_block(\d)/up$"), r"up_block\1.conv"),
    (re.compile(r"^up_block(\d)/res_conv(\d)$"),
     lambda m: f"up_block{m.group(1)}.b.{3 * int(m.group(2))}"),
    (re.compile(r"^up_block(\d)/res_gn(\d)$"),
     lambda m: f"up_block{m.group(1)}.b.{3 * int(m.group(2)) + 1}"),
    (re.compile(r"^up_block4$"), "up_block4"),
    (re.compile(r"^cube_embedding$"), "cube_embedding.proj"),
    (re.compile(r"^cube_embedding/norm$"), "cube_embedding.norm"),
]

_SUB_RULES = [
    (re.compile(r"^norm$"), "norm"),           # attention pre-norm (g/b)
    (re.compile(r"^to_qkv$"), "to_qkv"),
    (re.compile(r"^to_out$"), "to_out"),
    (re.compile(r"^dpb/fc([012])$"), lambda m: f"dpb.layers.{3 * int(m.group(1))}"),
    (re.compile(r"^dpb/ln([012])$"), lambda m: f"dpb.layers.{3 * int(m.group(1)) + 1}"),
    (re.compile(r"^dpb/fc_out$"), "dpb.layers.9"),
]
_FF_SUB = [
    (re.compile(r"^norm$"), "layers.0"),
    (re.compile(r"^fc1$"), "layers.1"),
    (re.compile(r"^fc2$"), "layers.4"),
]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _expand(rule, m) -> str:
    return m.expand(rule) if isinstance(rule, str) else rule(m)


def _map_path(path: str):
    """The port's module path ('a/b', no leaf) -> CREDIT key prefix, or None."""
    for block_rx, block_sub in _RULES:
        m = block_rx.match(path)
        if m:
            return _expand(block_sub, m)
    # two levels: block + submodule
    parts = path.split("/")
    for block_rx, block_sub in _RULES:
        m = block_rx.match("/".join(parts[:2]))
        if m:
            prefix = _expand(block_sub, m)
            rest = "/".join(parts[2:])
            subs = _FF_SUB if "_ff" in parts[1] else _SUB_RULES
            for rx, sub in subs:
                sm = rx.match(rest)
                if sm:
                    return f"{prefix}.{_expand(sub, sm)}"
    return None


def _convert_kernel(src: np.ndarray, target_shape, transposed: bool = False) -> np.ndarray:
    if src.ndim == 4 and len(target_shape) == 2:
        return src[:, :, 0, 0].T  # 1x1 conv (O, I, 1, 1) -> dense (I, O)
    if src.ndim == 2 and len(target_shape) == 2:
        return src.T  # Linear (O, I) -> (I, O)
    if src.ndim == 4 and len(target_shape) == 4:
        # ConvTranspose (I, O, kh, kw) or Conv OIHW -> (kh, kw, I, O)
        out = src.transpose(2, 3, 0, 1) if transposed else src.transpose(2, 3, 1, 0)
        if out.shape == tuple(target_shape):
            return out
    if src.ndim == 5 and len(target_shape) == 5:
        return src.transpose(2, 3, 4, 1, 0)  # Conv3d (O,I,kd,kh,kw) -> DHWIO
    raise ValueError(f"cannot convert kernel {src.shape} -> {tuple(target_shape)}")


def _convert_v(v: np.ndarray, src_kernel: np.ndarray) -> np.ndarray:
    """spectral v: torch's column order (I, kh, kw) -> HWIO's (kh, kw, I).
    A conv's columns are dims (1, 2, 3) of its OIHW weight; a transposed
    conv's (dim=1 spectral norm) dims (0, 2, 3) of its (I, O, kh, kw) one;
    credit_tpu tells them apart by v's length, which agree where I == O."""
    if src_kernel.ndim == 4:
        if v.shape[0] == int(np.prod(src_kernel.shape[1:])):  # conv: (I*kh*kw)
            i, kh, kw = src_kernel.shape[1], src_kernel.shape[2], src_kernel.shape[3]
        else:  # transposed conv: rows were dim 1 (O); columns (I, kh, kw)
            i, kh, kw = src_kernel.shape[0], src_kernel.shape[2], src_kernel.shape[3]
        return v.reshape(i, kh, kw).transpose(1, 2, 0).reshape(-1)
    return v


def _template(conf: dict):
    """(params, spectral, transposed): the port's training model's parameter
    and u/v shapes as nested dicts in module order (built on the meta
    device), and the module paths ('a/b') of its transposed convs."""
    from credit_torch.models import load_model
    from credit_torch.models.layers import ConvTranspose

    model = load_model(conf, device="meta", sn_state=True)
    names = {k for k, _ in model.named_parameters()}
    params, spectral = {}, {}
    for k, v in model.state_dict().items():
        *path, leaf = k.split(".")
        node = params if k in names else spectral
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = tuple(v.shape)
    transposed = {n.replace(".", "/") for n, m in model.named_modules()
                  if isinstance(m, ConvTranspose)}
    return params, spectral, transposed


def _initialised(conf: dict):
    """A getter of the port's seeded training state for `conf` (`init_train`
    on the CPU: seeded kernels, converged u/v), built at its first call.
    With strict off, the leaves a checkpoint leaves unwritten start from it,
    as credit_tpu's convert-checkpoint starts from `model.init`'s variables
    (zeros would give an unwritten u or v a sigma of 0 when folded)."""
    cache = {}

    def get(name: str) -> torch.Tensor:
        if not cache:
            from credit_torch.convert_jax import init_train

            model = init_train(conf, torch.Generator().manual_seed(0), device="cpu")
            cache.update(model.state_dict())
        return cache[name]

    return get


def _tensors(tree, initial, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_tensors(v, initial, name))
        elif isinstance(v, tuple):  # left unwritten (strict off): the seeded init
            out[name] = initial(name).detach().clone()
        else:
            out[name] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return out


def _unwritten(tree, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _unwritten(v, name)
        elif isinstance(v, tuple):
            yield name


def convert_crossformer(state_dict: Dict[str, Any], conf: dict,
                        strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's state (f32 CPU tensors, kernels unfolded, u/v beside
    them) for `conf`'s CrossFormer from a CREDIT CrossFormer state dict.
    With strict, a module of the port no rule maps, a parameter left
    unwritten or a CREDIT key left unused raises KeyError."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    params, spectral, transposed = _template(conf)
    used, missing = set(), []

    def walk(ptree, stree, path):
        leaf_names = [k for k, v in ptree.items() if not isinstance(v, dict)]
        if leaf_names:
            ref = _map_path(path)
            if ref is None:
                missing.append(path)
                return
            has_sn = isinstance(stree, dict) and "u" in stree
            w_key = f"{ref}.weight_orig" if f"{ref}.weight_orig" in sd else f"{ref}.weight"
            for leaf in leaf_names:
                shape = ptree[leaf]
                if leaf == "kernel":
                    src = sd.get(w_key)
                    if src is None:
                        missing.append(f"{path}/kernel <- {w_key}")
                        continue
                    ptree[leaf] = _convert_kernel(src, shape, path in transposed)
                    used.add(w_key)
                elif leaf == "bias" and f"{ref}.bias" in sd:
                    ptree[leaf] = sd[f"{ref}.bias"].reshape(shape)
                    used.add(f"{ref}.bias")
                elif leaf == "scale":
                    for cand in (f"{ref}.g", f"{ref}.weight"):
                        if cand in sd:
                            ptree[leaf] = sd[cand].reshape(shape)
                            used.add(cand)
                            break
                elif leaf == "bias" and f"{ref}.b" in sd:
                    ptree[leaf] = sd[f"{ref}.b"].reshape(shape)
                    used.add(f"{ref}.b")
            if has_sn:
                u_key, v_key = f"{ref}.weight_u", f"{ref}.weight_v"
                if u_key in sd:
                    stree["u"] = sd[u_key]
                    stree["v"] = _convert_v(sd[v_key], sd[w_key])
                    used.update((u_key, v_key))
            return
        for k, sub in ptree.items():
            walk(sub, stree.get(k, {}) if isinstance(stree, dict) else {},
                 f"{path}/{k}" if path else k)

    walk(params, spectral, "")
    missing += [p for p in (*_unwritten(params), *_unwritten(spectral)) if p not in missing]
    if strict and missing:
        raise KeyError(f"unmapped modules: {missing[:10]} (+{max(0, len(missing) - 10)} more)")
    leftover = {k for k in sd if k not in used
                and not k.startswith("cube_embedding")  # unused when patch = 1
                and "rel_pos_indices" not in k}
    if strict and leftover:
        raise KeyError(f"unconsumed reference keys: {sorted(leftover)[:10]}")
    initial = _initialised(conf)
    return {**_tensors(params, initial), **_tensors(spectral, initial)}


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A torch .pt checkpoint file as numpy arrays (CREDIT's
    {'model_state_dict': ...} containers, base_trainer._save_checkpoint)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state_dict", "state_dict", "module"):
        if isinstance(payload, dict) and key in payload:
            payload = payload[key]
    return {k.replace("module.", ""): _np(v) for k, v in payload.items()}


# ---------------------------------------------------------------------------
# FuXi (CREDIT credit/models/fuxi.py with timm's SwinTransformerV2Stage core)


def _fold_sn(sd: Dict[str, np.ndarray], prefix: str) -> np.ndarray:
    """The eval-mode weight of a spectrally normalised torch layer:
    weight_orig / sigma with sigma = u . (W v) (torch's old-API eval
    semantics); the plain `weight` where the layer has none."""
    if f"{prefix}.weight_orig" in sd:
        w = sd[f"{prefix}.weight_orig"]
        u = sd[f"{prefix}.weight_u"]
        v = sd[f"{prefix}.weight_v"]
        if w.ndim == 4 and w.shape[0] != u.shape[0]:  # ConvTranspose: dim=1
            w2d = np.moveaxis(w, 1, 0).reshape(w.shape[1], -1)
        else:
            w2d = w.reshape(w.shape[0], -1)
        sigma = float(u @ (w2d @ v))
        return w / sigma
    return sd[f"{prefix}.weight"]


def convert_fuxi(state_dict: Dict[str, Any], conf: dict,
                 strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's state for `conf`'s FuXi from a CREDIT FuXi state dict.
    The Down/UpBlock convs keep their spectral norm (weight_orig and u/v);
    the SwinV2 core and the fc head (plain dense layers here) take the
    eval-mode weights, sigma folded. With strict, a parameter left
    unwritten or a CREDIT key left unused raises KeyError."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    params, spectral, _ = _template(conf)
    used = set()

    def put(tree, path, value):
        node = tree
        for k in path[:-1]:
            node = node[k]
        shape = node[path[-1]]
        if isinstance(shape, np.ndarray):
            shape = shape.shape
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"{'.'.join(path)}: {tuple(value.shape)} != {tuple(shape)}")
        node[path[-1]] = value

    def sn_layer(my_path, ref_prefix, kind):
        """kind: conv | convT; keeps the layer's spectral norm (u/v) where
        the checkpoint has it."""
        w_key = f"{ref_prefix}.weight_orig" if f"{ref_prefix}.weight_orig" in sd \
            else f"{ref_prefix}.weight"
        w = sd[w_key]
        used.add(w_key)
        if kind == "conv":
            put(params, my_path + ["kernel"], w.transpose(2, 3, 1, 0))
        else:  # convT (I, O, kh, kw) -> (kh, kw, I, O)
            put(params, my_path + ["kernel"], w.transpose(2, 3, 0, 1))
        if f"{ref_prefix}.bias" in sd:
            put(params, my_path + ["bias"], sd[f"{ref_prefix}.bias"])
            used.add(f"{ref_prefix}.bias")
        if f"{ref_prefix}.weight_u" in sd:
            put(spectral, my_path + ["u"], sd[f"{ref_prefix}.weight_u"])
            put(spectral, my_path + ["v"], _convert_v(sd[f"{ref_prefix}.weight_v"], w))
            used.update((f"{ref_prefix}.weight_u", f"{ref_prefix}.weight_v"))

    def dense_folded(my_path, ref_prefix, bias: bool = True):
        w = _fold_sn(sd, ref_prefix)
        for cand in (f"{ref_prefix}.weight_orig", f"{ref_prefix}.weight",
                     f"{ref_prefix}.weight_u", f"{ref_prefix}.weight_v"):
            if cand in sd:
                used.add(cand)
        put(params, my_path + ["kernel"], w.T)
        if bias and f"{ref_prefix}.bias" in sd:
            put(params, my_path + ["bias"], sd[f"{ref_prefix}.bias"])
            used.add(f"{ref_prefix}.bias")

    def norm(my_path, ref_prefix, names=("scale", "bias")):
        put(params, my_path + [names[0]], sd[f"{ref_prefix}.weight"])
        put(params, my_path + [names[1]], sd[f"{ref_prefix}.bias"])
        used.update((f"{ref_prefix}.weight", f"{ref_prefix}.bias"))

    # cube embedding: Conv3d (O, I, kd, kh, kw) -> (kd, kh, kw, I, O)
    put(params, ["cube_embedding", "kernel"],
        sd["cube_embedding.proj.weight"].transpose(2, 3, 4, 1, 0))
    put(params, ["cube_embedding", "bias"], sd["cube_embedding.proj.bias"])
    used.update(("cube_embedding.proj.weight", "cube_embedding.proj.bias"))
    norm(["cube_embedding", "norm"], "cube_embedding.norm")

    # the U-transformer's down and up conv blocks
    for blk, kind in (("down", "conv"), ("up", "convT")):
        base = f"u_transformer.{blk}"
        my = ["u_transformer", blk]
        sn_layer(my + [blk], f"{base}.conv", kind)
        for r in range(2):
            sn_layer(my + [f"res_conv{r}"], f"{base}.b.{3 * r}", "conv")
            norm(my + [f"res_gn{r}"], f"{base}.b.{3 * r + 1}")

    # the SwinV2 stage's blocks (timm SwinTransformerV2Stage naming)
    i = 0
    while f"u_transformer.layer.blocks.{i}.norm1.weight" in sd:
        ref = f"u_transformer.layer.blocks.{i}"
        my = ["u_transformer", "swin", f"block{i}"]
        # timm's SwinV2 attention computes F.linear(x, self.qkv.weight, ...),
        # reading .weight as an attribute past torch spectral_norm's
        # pre-forward hook: under CREDIT's model-wide spectral norm qkv is
        # raw (weight_orig) at eval, while cpb_mlp / proj / mlp (called as
        # modules) are sigma-folded. The port reproduces that.
        if f"{ref}.attn.qkv.weight_orig" in sd:
            put(params, my + ["attn", "qkv", "kernel"], sd[f"{ref}.attn.qkv.weight_orig"].T)
            used.update((f"{ref}.attn.qkv.weight_orig",
                         f"{ref}.attn.qkv.weight_u", f"{ref}.attn.qkv.weight_v"))
        else:
            dense_folded(my + ["attn", "qkv"], f"{ref}.attn.qkv", bias=False)
        for b in ("q_bias", "v_bias"):
            put(params, my + ["attn", b], sd[f"{ref}.attn.{b}"])
            used.add(f"{ref}.attn.{b}")
        put(params, my + ["attn", "logit_scale"], sd[f"{ref}.attn.logit_scale"])
        used.add(f"{ref}.attn.logit_scale")
        dense_folded(my + ["attn", "cpb_fc1"], f"{ref}.attn.cpb_mlp.0")
        dense_folded(my + ["attn", "cpb_fc2"], f"{ref}.attn.cpb_mlp.2", bias=False)
        dense_folded(my + ["attn", "proj"], f"{ref}.attn.proj")
        norm(my + ["norm1"], f"{ref}.norm1")
        norm(my + ["norm2"], f"{ref}.norm2")
        dense_folded(my + ["mlp_fc1"], f"{ref}.mlp.fc1")
        dense_folded(my + ["mlp_fc2"], f"{ref}.mlp.fc2")
        i += 1

    # the fc head (a plain dense layer here; spectral norm folded)
    dense_folded(["fc"], "fc")

    leftover = {k for k in sd if k not in used
                and "relative_position" not in k and "attn_mask" not in k
                and "relative_coords_table" not in k}
    if strict and leftover:
        raise KeyError(f"unconsumed fuxi keys: {sorted(leftover)[:10]} "
                       f"(+{max(0, len(leftover) - 10)})")
    missing = list(_unwritten(params)) + list(_unwritten(spectral))
    if strict and missing:
        raise KeyError(f"fuxi parameters left unwritten: {missing[:10]} "
                       f"(+{max(0, len(missing) - 10)})")
    initial = _initialised(conf)
    return {**_tensors(params, initial), **_tensors(spectral, initial)}


def convert_checkpoint(state_dict: Dict[str, Any], conf: dict,
                       strict: bool = True) -> Dict[str, torch.Tensor]:
    """`convert_fuxi` for a `fuxi` model, else `convert_crossformer`, as
    credit_tpu's convert-checkpoint dispatches."""
    convert = convert_fuxi if conf["model"]["type"] == "fuxi" else convert_crossformer
    return convert(state_dict, conf, strict=strict)

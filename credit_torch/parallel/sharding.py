"""Placements of parameters, optimizer state and batches: port of
credit_tpu/parallel/sharding.py.

`param_spec` keeps credit_tpu's rule, which decides every placement:
tensor-parallel kernels (to_qkv / fc1 column-wise, to_out / fc2 row-wise)
over 'tp', then, with dp > 1, the largest dp-divisible remaining axis of a
tensor of 2^14 elements or more over 'dp' (ZeRO-3); everything else
replicated. credit_tpu hands these specs to GSPMD, which all-gathers the
weights per layer and reduce-scatters their gradients; the port applies
them itself:

- ZeRO-3 (`shard_parameters`, `ParamShards`): with dp > 1 every model
  parameter whose spec has 'dp' is held between steps as this rank's chunk
  along that axis (`_chunk`'s chunk order). The model is cut into blocks
  (`zero_blocks`: the model's children, a child marked `zero_container`
  taken apart into its own, and the model's own parameters); before a
  block's forward its held parameters are all-gathered over dp in one flat
  collective and swapped in whole, and after it the chunks go back. The
  gathered buffer is freed with the forward: the tensors autograd saves
  from it are kept as handles and gathered again, once, for the block's
  backward (`saved_tensors_hooks`), after which the block's gradients are
  reduce-scattered over dp in one flat collective onto the chunks. A
  tensor derived from a gathered weight (a cast to bf16, kernel / sigma)
  is saved as it is, as without ZeRO. Parameters under 2^14 elements or
  with no dp-divisible axis, and the postblock nets, stay whole;
- the AdamW moments (and MultiSteps' running mean) and the EMA live as this
  rank's chunk of each tensor along its spec's axes (`ShardedOptimizer`);
  each rank updates its chunks; a held parameter's update lands on its dp
  chunk (the tp chunks' updates all-gathered over tp), a whole one's is
  all-gathered over each of its axes, one flat collective per mesh axis
  (credit_tpu's `opt_state_shardings`);
- gradients: the whole ones are summed over the process group in one flat
  all-reduce, the held chunks (summed over dp by the reduce-scatter) over
  their tp and domain peers in another, and each is divided by the number
  of ranks that computed the same contribution (`reduce_gradients`).

`batch_spec` / `shard_batch` take this rank's dp rows of a global batch;
the latitude slab is taken inside the model, after its earth or zero
padding (every registered model type is lat-sharded: the `_forward_slabs`
of models/crossformer.py, wxformer_next.py, unet.py, graph.py,
debugger.py, and fuxi.py, swin.py, regional.py's slab forwards).
"""

from __future__ import annotations

import collections
import contextlib
import math
import re
import weakref
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from credit_torch.parallel import distributed as D


def batch_spec(ndim: int = 5, domain_axis: Optional[int] = 2) -> tuple:
    """Batch tensors (B, T, lat, lon, C): batch over dp and, where given,
    latitude over domain (credit_tpu's PartitionSpec as a tuple)."""
    spec = [None] * ndim
    spec[0] = "dp"
    if domain_axis is not None and ndim > domain_axis:
        spec[domain_axis] = "domain"
    return tuple(spec)


# TP rules: parameter path regex -> which axis of the kernel is sharded
# over 'tp' (column-parallel qkv / fc1 on the last axis, row-parallel to_out
# / fc2 on axis -2; reference: credit/models/wxformer/wxformer_next.py:58-109)
_TP_RULES = (
    (re.compile(r"to_qkv/kernel$"), -1),
    (re.compile(r"fc1/kernel$"), -1),
    (re.compile(r"to_out/kernel$"), -2),
    (re.compile(r"fc2/kernel$"), -2),
)


def _largest_divisible_axis(shape, size: int) -> Optional[int]:
    best, best_dim = None, 0
    for i, d in enumerate(shape):
        if d % size == 0 and d > best_dim:
            best, best_dim = i, d
    return best


def param_spec(path: str, shape, mesh) -> tuple:
    """The placement of one parameter, a tuple of axis names or None per
    dim. `path` is '/'-joined (a state_dict key's dots may be given)."""
    path = path.replace(".", "/")
    spec = [None] * len(shape)
    if mesh.shape["tp"] > 1:
        for rx, ax in _TP_RULES:
            if rx.search(path):
                ax = ax % len(shape)
                if shape[ax] % mesh.shape["tp"] == 0:
                    spec[ax] = "tp"
                break
    n = 1
    for s in shape:
        n *= int(s)
    if mesh.shape["dp"] > 1 and n >= 2**14:
        free = [i for i, s in enumerate(spec) if s is None]
        cand = _largest_divisible_axis([shape[i] for i in free], mesh.shape["dp"])
        if cand is not None:
            spec[free[cand]] = "dp"
    return tuple(spec)


def shard_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's dp rows of a global batch (tp and domain peers get the
    same rows)."""
    dp, r = mesh.shape["dp"], mesh.coord("dp")
    if dp == 1:
        return batch
    return {k: None if v is None else v.chunk(dp, dim=0)[r] for k, v in batch.items()}


def batch_sharding(mesh, ndim: int = 5, domain: bool = True):
    """`batch_spec` applied: a function taking a global batch tensor
    (B, T, lat, lon, C) to this rank's dp rows and, with `domain` and
    domain > 1, its latitude slab (the lat-sharded models take the slab
    themselves, after their earth padding, so the trainer feeds rows)."""
    from credit_torch.parallel.halo import shard_lat

    dom = domain and mesh.shape["domain"] > 1

    def take(t: torch.Tensor) -> torch.Tensor:
        t = t.chunk(mesh.shape["dp"], dim=0)[mesh.coord("dp")]
        if dom and t.dim() == ndim:
            t = shard_lat(t, mesh.shape["domain"], mesh.coord("domain"))
        return t

    return take


def _chunk(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    for ax, name in enumerate(spec):
        if name is not None:
            t = t.chunk(mesh.shape[name], dim=ax)[mesh.coord(name)]
    return t


def zero_blocks(model: nn.Module) -> List[nn.Module]:
    """The modules ZeRO-3 gathers one at a time: the model's children, a
    child marked `zero_container` taken apart into its own children (a
    CrossFormer's cel{i}, transformer{i} and up_block{i}; FuXi's cube
    embed, DownBlock, each SwinBlockV2, UpBlock and head)."""
    out: List[nn.Module] = []
    _walk_blocks(model, out)
    return out


def _walk_blocks(mod: nn.Module, out: List[nn.Module]) -> None:
    """zero_blocks' walk (at module level: a recursive closure would hold
    `out`, and with it the model's blocks, in a reference cycle)."""
    for child in mod.children():
        if getattr(child, "zero_container", False):
            _walk_blocks(child, out)
        else:
            out.append(child)


class _Block:
    """A block's held parameters: `items` (owner module, attribute, dp
    axis) in a fixed order, their state_dict names in `names`. The block
    of the model's own parameters holds the model by a weak reference: the
    model holds its ParamShards, so a strong one would make a cycle that
    keeps the model's memory until Python's cyclic collector runs."""

    def __init__(self, module: nn.Module, weak: bool = False):
        self._module = weakref.ref(module) if weak else module
        self.items, self.names = [], []

    @property
    def module(self) -> nn.Module:
        return self._module() if isinstance(self._module, weakref.ref) else self._module


class _Gather:
    """One forward's gather of a block: the chunks it gathered, and the
    buffers gathered again for its backward (until that ends)."""

    __slots__ = ("block", "chunks", "buf")

    def __init__(self, block, chunks):
        self.block, self.chunks, self.buf = block, chunks, None


class _Saved:
    """A tensor autograd saved from a gathered parameter (a view of it)."""

    __slots__ = ("rec", "index", "size", "stride", "offset")

    def __init__(self, rec, index, t):
        self.rec, self.index = rec, index
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()


class _GatherParams(torch.autograd.Function):
    """Forward: a block's dp chunks all-gathered whole; backward: the whole
    gradients reduce-scattered onto the chunks (each one flat collective
    over dp)."""

    @staticmethod
    def forward(ctx, shards, rec, *chunks):
        ctx.shards, ctx.rec = shards, rec
        return tuple(shards._gather(rec.block, chunks))

    @staticmethod
    def backward(ctx, *grads):
        ctx.rec.buf = None  # this block's backward is over
        return (None, None, *ctx.shards._reduce_scatter(ctx.rec.block, grads))


class ParamShards:
    """ZeRO-3 over dp on a model (see the module): built by
    `shard_parameters`, it holds the dp chunks in the model's own
    Parameters (the same objects, their data replaced by the chunk) and
    gathers each block around its forward through module hooks. `held`
    names the chunked parameters; `state_dict` / `load_state_dict` move
    whole tensors in and out (a checkpoint's), `each_block(fn)` runs fn on
    each block with its parameters whole, outside autograd (spectral
    norm's external power iterations), `unsharded()` holds the whole model
    for a while (a seeded init)."""

    def __init__(self, model: nn.Module, mesh):
        self.mesh = mesh
        self.n, self.group = mesh.shape["dp"], mesh.group("dp")
        self.all_blocks = [_Block(m) for m in zero_blocks(model)]
        root = _Block(model, weak=True)
        owner = {}
        for b in self.all_blocks:
            for m in b.module.modules():
                owner[id(m)] = b
        self.held = set()
        for prefix, mod in model.named_modules():
            for name, p in mod._parameters.items():
                if p is None:
                    continue
                full = f"{prefix}.{name}" if prefix else name
                spec = param_spec(full, tuple(p.shape), mesh)
                if "dp" not in spec:
                    continue
                ax = spec.index("dp")
                block = owner.get(id(mod), root)
                block.items.append((mod, name, ax))
                block.names.append(full)
                with torch.no_grad():
                    p.data = p.data.chunk(self.n, dim=ax)[mesh.coord("dp")].clone()
                self.held.add(full)
        # the blocks with held parameters, the model's own last
        self.blocks = [b for b in self.all_blocks + [root] if b.items]
        self._live: Dict[int, tuple] = {}  # storage of a gathered parameter -> (gather, index)
        # the views of gathered parameters autograd saved as handles (those
        # smaller than their parameter: tp slices), and the backward's
        # re-gathers, since the model was sharded
        self.counts: collections.Counter = collections.Counter()
        self._stack: List[tuple] = []
        # the hooks reach this object through a weak reference and find their
        # block by their module (the model holds this object: see _Block; a
        # hook holding it or its block would close a reference cycle), so
        # deleting the model frees it at once
        me = weakref.ref(self)
        self._block_of = {id(b.module): b for b in self.blocks if b is not root}
        for b in self.blocks:
            if b is not root:
                b.module.register_forward_pre_hook(
                    lambda mod, args: me()._enter(me()._block_of[id(mod)]))
                b.module.register_forward_hook(
                    lambda mod, args, out: me()._exit(me()._block_of[id(mod)]), always_call=True)
        root = root if root.items else None
        model.register_forward_pre_hook(lambda mod, args: me()._enter_root(root))
        model.register_forward_hook(lambda mod, args, out: me()._exit_root(root),
                                    always_call=True)

    # -- collectives
    def _gather(self, block: _Block, chunks) -> List[torch.Tensor]:
        flat = torch.cat([c.detach().reshape(-1) for c in chunks])
        full = D.all_gather(flat, 0, self.group).reshape(self.n, -1)
        out, off = [], 0
        for (_, _, ax), c in zip(block.items, chunks):
            parts = full[:, off:off + c.numel()].reshape(self.n, *c.shape)
            out.append(torch.cat(list(parts), dim=ax))
            off += c.numel()
        return out

    def _reduce_scatter(self, block: _Block, grads) -> List[torch.Tensor]:
        send = torch.cat([torch.stack(g.chunk(self.n, dim=ax)).reshape(self.n, -1)
                          for g, (_, _, ax) in zip(grads, block.items)], dim=1)
        mine = D.reduce_scatter(send.reshape(-1), 0, self.group)
        out, off = [], 0
        for g, (_, _, ax) in zip(grads, block.items):
            shape = list(g.shape)
            shape[ax] //= self.n
            out.append(mine[off:off + math.prod(shape)].reshape(shape))
            off += math.prod(shape)
        return out

    # -- the forward's hooks
    def _enter(self, block: _Block):
        chunks = [mod._parameters[name] for mod, name, _ in block.items]
        rec = _Gather(block, chunks)
        if torch.is_grad_enabled() and any(c.requires_grad for c in chunks):
            fulls = _GatherParams.apply(self, rec, *chunks)
        else:
            with torch.no_grad():
                fulls = self._gather(block, chunks)
        keys = []
        for i, ((mod, name, _), f) in enumerate(zip(block.items, fulls)):
            mod._parameters[name] = f
            key = f.untyped_storage().data_ptr()
            self._live[key] = (rec, i)
            keys.append(key)
        self._stack.append((block, chunks, keys))

    def _exit(self, block: _Block):
        top, chunks, keys = self._stack.pop()
        assert top is block, "ZeRO-3 blocks left out of order"
        for (mod, name, _), c in zip(block.items, chunks):
            mod._parameters[name] = c
        for k in keys:
            self._live.pop(k, None)

    def _enter_root(self, root):
        hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)
        hooks.__enter__()
        self._stack.append((None, hooks, None))
        if root is not None:
            self._enter(root)

    def _exit_root(self, root):
        if root is not None:
            self._exit(root)
        self._stack.pop()[1].__exit__(None, None, None)

    def _pack(self, t: torch.Tensor):
        hit = self._live.get(t.untyped_storage().data_ptr()) if self._live else None
        if hit is None:
            return t
        # a view of a gathered parameter (a tp rank's slice of it included)
        # is kept as a handle: the gathered buffer is freed with the forward
        self.counts["saved_views"] += 1
        if t.numel() < hit[0].chunks[hit[1]].numel() * self.n:
            self.counts["saved_slices"] += 1
        return _Saved(hit[0], hit[1], t)

    def _unpack(self, h):
        if not isinstance(h, _Saved):
            return h
        rec = h.rec
        if rec.buf is None:  # once per block and backward
            self.counts["regathers"] += 1
            with torch.no_grad():
                rec.buf = self._gather(rec.block, rec.chunks)
        return rec.buf[h.index].as_strided(h.size, h.stride, h.offset)

    # -- whole tensors
    @contextlib.contextmanager
    def _whole(self, block: _Block):
        if not block.items:
            yield []
            return
        chunks = [mod._parameters[name] for mod, name, _ in block.items]
        with torch.no_grad():
            fulls = self._gather(block, chunks)
        for (mod, name, _), f in zip(block.items, fulls):
            mod._parameters[name] = f
        try:
            yield fulls
        finally:
            for (mod, name, _), c in zip(block.items, chunks):
                mod._parameters[name] = c

    @contextlib.contextmanager
    def unsharded(self):
        """The held parameters whole (in their own Parameters) inside the
        block, this rank's chunks of them again after (a seeded init of
        the whole model); collective over dp."""
        c = self.mesh.coord("dp")
        with torch.no_grad():
            for b in self.blocks:
                fulls = self._gather(b, [mod._parameters[name] for mod, name, _ in b.items])
                for (mod, name, _), f in zip(b.items, fulls):
                    mod._parameters[name].data = f
        try:
            yield
        finally:
            with torch.no_grad():
                for b in self.blocks:
                    for mod, name, ax in b.items:
                        p = mod._parameters[name]
                        p.data = p.data.chunk(self.n, dim=ax)[c].clone()

    def each_block(self, fn) -> None:
        """fn(module) on every block (`zero_blocks`), one at a time, with
        its parameters whole (no gradient); collective over dp."""
        for b in self.all_blocks:
            with self._whole(b):
                fn(b.module)

    def state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """model.state_dict() with every held parameter whole (one
        all-gather a block; every rank of the dp group takes part)."""
        sd = model.state_dict()
        for b in self.blocks:
            with self._whole(b) as fulls:
                sd.update(zip(b.names, (f.detach() for f in fulls)))
        return sd

    def load_state_dict(self, model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
        """model.load_state_dict from whole tensors, each held one cut to
        this rank's chunk."""
        axes = {n: ax for b in self.blocks for n, (_, _, ax) in zip(b.names, b.items)}
        c = self.mesh.coord("dp")
        model.load_state_dict({k: v.chunk(self.n, dim=axes[k])[c] if k in axes else v
                               for k, v in sd.items()})


def shard_parameters(model: nn.Module, mesh) -> Optional[ParamShards]:
    """ZeRO-3 on `model` over the mesh's dp axis (idempotent; None without
    a mesh or at dp = 1). The parameters keep their objects; their data
    becomes this rank's chunk."""
    if mesh is None or mesh.shape["dp"] == 1:
        return None
    shards = model.__dict__.get("_param_shards")
    if shards is None:
        shards = ParamShards(model, mesh)
        model.__dict__["_param_shards"] = shards
    return shards


def param_shards(model: nn.Module) -> Optional[ParamShards]:
    """The model's ParamShards, or None where its parameters are whole."""
    return model.__dict__.get("_param_shards")


class ShardedOptimizer:
    """An optimizer (trainers.trainer.AdamW or MultiSteps) whose state is
    this rank's chunks of each tensor, placed by `param_spec` (`names`
    and `shapes` are the whole tensors'). `shard_parameters(model)` applies
    ZeRO-3 to the model (TrainState.create calls it) and records the held
    parameters. `init` and `update` take the tensors as the model holds
    them (a held parameter as its dp chunk, the others whole); update
    returns the updates in that form, the chunks' updates all-gathered over
    the axes the held form keeps whole (tp for a held parameter, each of
    its axes for a whole one), one flat all-gather per mesh axis. Clipping
    takes the global norm over the chunks, each counted once. `chunk` /
    `view` give this rank's chunk of a tensor in the held form (the EMA
    follows the parameters' chunks), `view_whole` of a whole one."""

    def __init__(self, inner, mesh, names: Sequence[str], shapes: Sequence[tuple]):
        self.inner, self.mesh = inner, mesh
        self.specs = {k: param_spec(k, s, mesh) for k, s in zip(names, shapes)}
        adam = getattr(inner, "inner", inner)
        adam.norm_fn = self._global_norm
        # ranks that hold the same chunk: the world over the chunk count
        self._copies = {k: D.world_size() // self._n_chunks(s) for k, s in self.specs.items()}
        self.held = set()

    def _n_chunks(self, spec: tuple) -> int:
        n = 1
        for name in spec:
            if name is not None:
                n *= self.mesh.shape[name]
        return n

    def _local(self, name: str) -> tuple:
        """The spec of the optimizer's chunk within the held form."""
        spec = self.specs[name]
        return tuple(None if a == "dp" else a for a in spec) if name in self.held else spec

    def shard_parameters(self, model: nn.Module):
        shards = shard_parameters(model, self.mesh)
        if shards is not None:
            self.held |= shards.held & set(self.specs)
        return shards

    @property
    def schedule(self):
        return getattr(self.inner, "inner", self.inner).schedule

    def chunk(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.view(name, t).clone()

    def view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of a tensor in the held form, a view of it."""
        return _chunk(t, self._local(name), self.mesh)

    def view_whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of a whole tensor, a view of it."""
        return _chunk(t, self.specs[name], self.mesh)

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return self.inner.init({k: self.chunk(k, p) for k, p in params.items()})

    def _global_norm(self, chunks: List[torch.Tensor]) -> torch.Tensor:
        names = list(self.specs)
        sq = torch.stack([c.float().pow(2).sum() / self._copies[k] for k, c in zip(names, chunks)])
        return torch.sqrt(D.all_reduce(sq.sum()))

    def norm(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of tensors in the held form (the reduced
        gradients), each element counted once."""
        world, dp = D.world_size(), self.mesh.shape["dp"]
        sq = torch.stack([t.float().pow(2).sum() / (world // (dp if k in self.held else 1))
                          for k, t in zip(self.specs, tensors)])
        return torch.sqrt(D.all_reduce(sq.sum()))

    def update(self, grads: List[torch.Tensor], state: dict, params: List[torch.Tensor]):
        names = list(self.specs)
        gch = [self.view(k, g) for k, g in zip(names, grads)]
        pch = [self.view(k, p) for k, p in zip(names, params)]
        upd, state = self.inner.update(gch, state, pch)
        if upd is None:
            return None, state
        return self.unshard(dict(zip(names, upd))), state

    def _gather(self, chunks: Dict[str, torch.Tensor], specs: Dict[str, tuple]):
        out = dict(chunks)
        for axis in ("dp", "tp"):
            if self.mesh.shape[axis] == 1:
                continue
            names = [k for k in out if axis in specs[k]]
            if not names:
                continue
            n = self.mesh.shape[axis]
            flat = torch.cat([out[k].reshape(-1) for k in names])
            full = D.all_gather(flat, 0, self.mesh.group(axis)).reshape(n, -1)
            off = 0
            for k in names:
                c = out[k]
                parts = full[:, off:off + c.numel()].reshape(n, *c.shape)
                out[k] = torch.cat(list(parts), dim=specs[k].index(axis))
                off += c.numel()
        return [out[k] for k in self.specs]

    def unshard(self, chunks: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Tensors in the held form from every rank's chunks, in the order
        of the state's keys: per mesh axis, one all-gather of the chunks
        sharded along it, flattened."""
        return self._gather(chunks, {k: self._local(k) for k in self.specs})

    def whole(self, chunks: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors from every rank's chunks (a checkpoint's)."""
        return self._gather(chunks, self.specs)

    def held_whole(self, tensors: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors from tensors in the held form (the parameters, the
        reduced gradients): the held ones all-gathered over dp."""
        return self._gather(tensors, {k: tuple(a if a == "dp" and k in self.held else None
                                               for a in s) for k, s in self.specs.items()})

    def full_state(self, state: dict) -> dict:
        """The optimizer state with whole tensors (a checkpoint's)."""
        return {k: dict(zip(self.specs, self.whole(v))) if isinstance(v, dict) else v
                for k, v in state.items()}

    def load_full_state(self, state: dict, full: dict) -> dict:
        """`state` with its chunks copied from whole tensors."""
        with torch.no_grad():
            for name, part in state.items():
                if isinstance(part, dict):
                    for k, v in part.items():
                        v.copy_(self.view_whole(k, full[name][k].to(v.device)))
        return {**state, **{k: v for k, v in full.items() if not isinstance(v, dict)}}


def reduce_gradients(grads: List[torch.Tensor], divisors: Sequence[float],
                     held: Optional[Sequence[bool]] = None, peers=None) -> List[torch.Tensor]:
    """Each gradient summed over the ranks that computed a share of it,
    then divided by its divisor (the ranks that computed the same
    contribution times the dp size: `gradient_divisors`). A whole gradient
    is summed over the process group, a held chunk (`held`, ZeRO-3: already
    summed over dp) over its tp and domain peers (`peers`, None where there
    are none), each kind in one flat all-reduce."""
    held = list(held) if held is not None else [False] * len(grads)
    out = list(grads)
    for kind in (False, True):
        idx = [i for i, h in enumerate(held) if h == kind]
        if not idx:
            continue
        flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
        if not kind:
            flat = D.all_reduce(flat)
        elif peers is not None:
            flat = D.all_reduce(flat, peers)
        off = 0
        for i in idx:
            g = grads[i]
            out[i] = (flat[off:off + g.numel()].reshape(g.shape) / divisors[i]).to(g.dtype)
            off += g.numel()
    return out


def gradient_divisors(names: Sequence[str], mesh, lat_sharded: bool,
                      tp_partial: Sequence[str] = (), whole: Sequence[str] = ()) -> List[float]:
    """What each parameter's gradient summed over the group is divided by:
    dp (the batch mean), times the domain size where every domain rank
    computes it on the whole field (all of a model that is not lat-sharded,
    and the parameters named in `whole`: the postblock nets after a
    lat-sharded model's last gather; a lat-sharded model's own ranks each
    hold their slab's share, also of a part every rank runs on a whole
    field before the last gather, as NextGen's bottleneck MLP on the
    pooled nodes: its gradient comes through this rank's rows), times the
    tp size for a parameter that every tp rank uses whole (not one of
    `tp_partial`: the attention blocks, whose ranks each hold their heads'
    share, and the FF blocks' fc1, fc2 kernels, fc1's bias and the
    pre-norm LN, whose ranks each hold their slice of the hidden
    layer's)."""
    dp, tp, dom = mesh.shape["dp"], mesh.shape["tp"], mesh.shape["domain"]
    part, full = set(tp_partial), set(whole)
    return [float(dp * (1 if lat_sharded and k not in full else dom)
                  * (1 if k in part else tp)) for k in names]


def all_reduce_mean(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The metrics' means over the process group, in one all-reduce."""
    keys = [k for k, v in values.items() if torch.is_tensor(v)]
    if not keys or D.world_size() == 1:
        return values
    stacked = D.all_reduce(torch.stack([values[k].float().reshape(()) for k in keys]))
    stacked = stacked / dist.get_world_size()
    return {**values, **{k: stacked[i] for i, k in enumerate(keys)}}

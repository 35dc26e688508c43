"""Placements of parameters, optimizer state and batches: port of
credit_tpu/parallel/sharding.py.

`param_spec` keeps credit_tpu's rule, which decides every placement:
tensor-parallel kernels (to_qkv / fc1 column-wise, to_out / fc2 row-wise)
over 'tp', then, with dp > 1, the largest dp-divisible remaining axis of a
tensor of 2^14 elements or more over 'dp' (the ZeRO analogue); everything
else replicated. credit_tpu hands these specs to GSPMD; the port applies
them itself:

- the AdamW moments (and MultiSteps' running mean) and the EMA live as this
  rank's chunk of each tensor along its spec's axes (`ShardedOptimizer`);
  each rank updates its chunks and the updates are all-gathered, one flat
  collective per mesh axis (credit_tpu's `opt_state_shardings`);
- the parameters themselves stay whole on every rank, so the forward and
  backward need no per-layer gathers; ZeRO-3's parameter sharding is not
  done (ROADMAP);
- gradients are summed over the whole process group in one flat all-reduce
  and divided per tensor by the number of ranks that computed the same
  contribution (`reduce_gradients`).

`batch_spec` / `shard_batch` take this rank's dp rows of a global batch;
the latitude slab is taken inside the model, after its earth padding
(models/crossformer.py).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

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


class ShardedOptimizer:
    """An optimizer (trainers.trainer.AdamW or MultiSteps) whose state is
    this rank's chunks of each tensor, placed by `param_spec`. `init` and
    `update` take whole tensors as the wrapped optimizer does; update
    returns whole updates (the chunks' updates all-gathered, one flat
    all-gather per mesh axis), so the caller applies them as it would
    unsharded. Clipping takes the global norm over the chunks, each
    counted once. `chunk` gives this rank's chunk of a whole tensor (the
    EMA follows the parameters' chunks)."""

    def __init__(self, inner, mesh, names: Sequence[str], shapes: Sequence[tuple]):
        self.inner, self.mesh = inner, mesh
        self.specs = {k: param_spec(k, s, mesh) for k, s in zip(names, shapes)}
        adam = getattr(inner, "inner", inner)
        adam.norm_fn = self._global_norm
        # ranks that hold the same chunk: the world over the chunk count
        self._copies = {k: D.world_size() // self._n_chunks(s) for k, s in self.specs.items()}

    def _n_chunks(self, spec: tuple) -> int:
        n = 1
        for name in spec:
            if name is not None:
                n *= self.mesh.shape[name]
        return n

    @property
    def schedule(self):
        return getattr(self.inner, "inner", self.inner).schedule

    def chunk(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.view(name, t).clone()

    def view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of a whole tensor, a view of it."""
        return _chunk(t, self.specs[name], self.mesh)

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return self.inner.init({k: self.chunk(k, p) for k, p in params.items()})

    def _global_norm(self, chunks: List[torch.Tensor]) -> torch.Tensor:
        names = list(self.specs)
        sq = torch.stack([c.float().pow(2).sum() / self._copies[k] for k, c in zip(names, chunks)])
        return torch.sqrt(D.all_reduce(sq.sum()))

    def update(self, grads: List[torch.Tensor], state: dict, params: List[torch.Tensor]):
        names = list(self.specs)
        gch = [_chunk(g, self.specs[k], self.mesh) for k, g in zip(names, grads)]
        pch = [_chunk(p, self.specs[k], self.mesh) for k, p in zip(names, params)]
        upd, state = self.inner.update(gch, state, pch)
        if upd is None:
            return None, state
        return self.unshard(dict(zip(names, upd))), state

    def unshard(self, chunks: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors from every rank's chunks, in the order of the
        state's keys: per mesh axis (the spec's last first), one all-gather
        of the chunks sharded along it, flattened."""
        out = dict(chunks)
        for axis in ("dp", "tp"):
            if self.mesh.shape[axis] == 1:
                continue
            names = [k for k in out if axis in self.specs[k]]
            if not names:
                continue
            n = self.mesh.shape[axis]
            flat = torch.cat([out[k].reshape(-1) for k in names])
            full = D.all_gather(flat, 0, self.mesh.group(axis)).reshape(n, -1)
            off = 0
            for k in names:
                c = out[k]
                parts = full[:, off:off + c.numel()].reshape(n, *c.shape)
                out[k] = torch.cat(list(parts), dim=self.specs[k].index(axis))
                off += c.numel()
        return [out[k] for k in self.specs]

    def full_state(self, state: dict) -> dict:
        """The optimizer state with whole tensors (a checkpoint's)."""
        return {k: dict(zip(self.specs, self.unshard(v))) if isinstance(v, dict) else v
                for k, v in state.items()}

    def load_full_state(self, state: dict, full: dict) -> dict:
        """`state` with its chunks copied from whole tensors."""
        with torch.no_grad():
            for name, part in state.items():
                if isinstance(part, dict):
                    for k, v in part.items():
                        v.copy_(_chunk(full[name][k].to(v.device), self.specs[k], self.mesh))
        return {**state, **{k: v for k, v in full.items() if not isinstance(v, dict)}}


def reduce_gradients(grads: List[torch.Tensor], divisors: Sequence[float]) -> List[torch.Tensor]:
    """Each gradient summed over the process group, in one flat all-reduce,
    then divided by its divisor (the ranks that computed the same
    contribution times the dp size: `gradient_divisors`)."""
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    flat = D.all_reduce(flat)
    out, off = [], 0
    for g, d in zip(grads, divisors):
        out.append((flat[off:off + g.numel()].reshape(g.shape) / d).to(g.dtype))
        off += g.numel()
    return out


def gradient_divisors(names: Sequence[str], mesh, lat_sharded: bool,
                      tp_partial: Sequence[str] = (), whole: Sequence[str] = ()) -> List[float]:
    """What each parameter's gradient summed over the group is divided by:
    dp (the batch mean), times the domain size where every domain rank
    computes it on the whole field (all of a model that is not lat-sharded,
    and the parameters named in `whole`: the postblock nets after a
    lat-sharded model's last gather; a lat-sharded model's own ranks each
    hold their slab's share), times the tp size for a parameter that every
    tp rank uses whole (not one of `tp_partial`: the attention blocks,
    whose ranks each hold their heads' share)."""
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

"""The parallel context the layers read: which mesh a step runs on, and
whether the tensors they see are latitude slabs.

`explicit_halo(mesh)` (credit_tpu's, ops/conv.py:60) carries the process
mesh of a parallel step; a lat-sharded model marks the parts of its forward
that run on latitude slabs with `lat_slabs()`. The convs (ops/conv.py),
GroupNorm, WindowAttention and the quadrant embed (models/layers.py) and
the CrossFormer family's forward read it through `domain_group()` and
`mesh()`. `on_full` is the gather path any of them takes where a slab does
not do, and `gather_whole` the one a lat-sharded model takes where a
stage's rows do not split; each counts its calls in `GATHERS` by the site
that took it (the rank's own count). Slabs are even unless the model says
otherwise: `lat_slabs(rows=)` gives each rank's row count (the SwinV2
stage's window-aligned slabs), which `slab_rows()` reads.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars

import torch

from credit_torch.parallel.halo import gather_lat, shard_lat

# (mesh, axis) of the parallel step, or None; and whether the tensors the
# ops see are latitude slabs (set by a lat-sharded model's forward)
_MESH = contextvars.ContextVar("credit_torch_mesh", default=None)
_SLABS = contextvars.ContextVar("credit_torch_lat_slabs", default=False)
_ROWS = contextvars.ContextVar("credit_torch_slab_rows", default=None)
# this rank's gather paths by site ("conv", "long_attn", "resize", a
# model's "stage", ...) since the last clear()
GATHERS: collections.Counter = collections.Counter()


@contextlib.contextmanager
def explicit_halo(mesh, axis: str = "domain"):
    """The process mesh of a parallel step (trainer.parallelism): inside it
    a lat-sharded model splits latitude over `axis` and the attention
    blocks split heads over 'tp'. No-op for mesh None."""
    tok = _MESH.set((mesh, axis) if mesh is not None else None)
    try:
        yield
    finally:
        _MESH.reset(tok)


def mesh():
    """The mesh of the enclosing `explicit_halo`, or None."""
    val = _MESH.get()
    return None if val is None else val[0]


def halo_mesh_active() -> bool:
    """True inside explicit_halo(mesh) with more than one domain rank."""
    val = _MESH.get()
    return val is not None and val[0].shape.get(val[1], 1) > 1


@contextlib.contextmanager
def lat_slabs(enable: bool = True, rows=None):
    """Inside explicit_halo with domain > 1: the tensors the ops see are
    this rank's latitude slabs (enable), or whole fields (enable False);
    `rows`, where the slabs are uneven, holds every rank's row count."""
    on = bool(enable) and halo_mesh_active()
    tok = _SLABS.set(on)
    tok_rows = _ROWS.set(tuple(rows) if on and rows is not None else None)
    try:
        yield
    finally:
        _ROWS.reset(tok_rows)
        _SLABS.reset(tok)


def slab_rows(local: int):
    """Every domain rank's slab rows where the ops see slabs: those given
    to `lat_slabs(rows=)`, else `local` on each rank (even slabs)."""
    rows = _ROWS.get()
    if rows is not None:
        return rows
    return (local,) * domain_group()[1]


def mesh_domain():
    """(group, size, rank) of the enclosing mesh's domain axis, whether or
    not the ops see slabs (a lat-sharded model's forward reads it)."""
    m, axis = _MESH.get()
    return m.group(axis), m.shape[axis], m.coord(axis)


def domain_group():
    """(group, size, rank) of the domain axis where the ops see slabs,
    else None."""
    if not _SLABS.get():
        return None
    m, axis = _MESH.get()
    return m.group(axis), m.shape[axis], m.coord(axis)


def on_full(fn, x: torch.Tensor, dom=None, site: str = "op") -> torch.Tensor:
    """The gather path: fn on the whole field gathered from the slabs
    (a reduce-scatter backward), then this rank's rows of its output
    (which must split evenly); counted in GATHERS[site]."""
    group, n, r = dom or domain_group()
    GATHERS[site] += 1
    with lat_slabs(False):
        y = fn(gather_lat(x, group))
    if y.shape[-3] % n:
        raise ValueError(f"{y.shape[-3]} output rows do not split over {n} domain ranks")
    return shard_lat(y, n, r)


def gather_whole(x: torch.Tensor, group, site: str) -> torch.Tensor:
    """A lat-sharded model's own gather path (`gather_lat`, a
    reduce-scatter backward) from its slabs to the whole field, where the
    rows from here on do not split; counted in GATHERS[site]."""
    GATHERS[site] += 1
    return gather_lat(x, group)

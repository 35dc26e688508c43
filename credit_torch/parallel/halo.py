"""Latitude-domain decomposition: port of credit_tpu/parallel/halo.py.

credit_tpu exchanges halo rows with lax.ppermute inside shard_map under a
custom VJP; the port does the same with point-to-point sends on the domain
group (`batch_isend_irecv`) inside autograd Functions. Layout: local blocks
(..., lat_local, lon, C); a rank's slab is rows [r * L, (r + 1) * L) of the
global latitude axis, L = H / n.

Besides the exchange, the autograd collectives a lat-sharded model needs:
`gather_lat` (all-gather; backward a reduce-scatter, or this rank's rows
when every rank computes the same thing downstream), `all_reduce_sum`
(backward an all-reduce, or the identity), `copy_to_group` (identity;
backward an all-reduce: Megatron's f) and `scale_grad`.

Slabs may be uneven: `shard_lat` and `gather_lat` take the ranks' row
counts (`counts`), and gloo's and NCCL's all-gathers, which want equal
sizes, get each slab padded to the largest and trimmed after. `window_rows`
splits R window rows as ceil(R/n) / floor(R/n) a rank, `reslab` moves a
field from one split of its rows to another (the SwinV2 stage's window
slabs), and `lat_roll` is the shifted window's cyclic `torch.roll` along
latitude across the slabs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from credit_torch.parallel import distributed as D

LAT_AXIS = -3


def _take_lat(x, start, size):
    idx = [slice(None)] * x.ndim
    idx[LAT_AXIS] = slice(start, start + size) if start >= 0 else slice(start, None)
    return x[tuple(idx)]


def _ring(group):
    return dist.get_world_size(group), dist.get_rank(group)


class _HaloExchange(torch.autograd.Function):
    """Pad the local block with `halo` rows from the north (rank - 1) and
    south (rank + 1) neighbours; edge ranks get zero rows. Backward: the
    halo rows' gradients go back to the rank that owns those rows and are
    added at its edges (reference: halo_exchange.py:79-142)."""

    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.halo, ctx.group = halo, group
        n, r = _ring(group)
        north = x.new_zeros(_take_lat(x, 0, halo).shape)
        south = torch.zeros_like(north)
        sends, recvs = [], []
        if r > 0:
            sends.append((_take_lat(x, 0, halo).contiguous(), r - 1))
            recvs.append((north, r - 1))
        if r < n - 1:
            sends.append((_take_lat(x, -halo, halo).contiguous(), r + 1))
            recvs.append((south, r + 1))
        D.exchange(sends, recvs, group)
        return torch.cat([north, x, south], dim=LAT_AXIS)

    @staticmethod
    def backward(ctx, g):
        halo, group = ctx.halo, ctx.group
        n, r = _ring(group)
        nl = g.shape[LAT_AXIS] - 2 * halo
        dx = _take_lat(g, halo, nl).clone()
        from_north = torch.zeros_like(_take_lat(dx, 0, halo))
        from_south = torch.zeros_like(from_north)
        sends, recvs = [], []
        if r > 0:  # my north halo's gradient belongs to the north rank's bottom rows
            sends.append((_take_lat(g, 0, halo).contiguous(), r - 1))
            recvs.append((from_north, r - 1))
        if r < n - 1:
            sends.append((_take_lat(g, -halo, halo).contiguous(), r + 1))
            recvs.append((from_south, r + 1))
        D.exchange(sends, recvs, group)
        top = _take_lat(dx, 0, halo)
        top += from_north
        bot = _take_lat(dx, nl - halo, halo)
        bot += from_south
        return dx, None, None


def halo_exchange(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """(..., L, lon, C) -> (..., L + 2*halo, lon, C): the local block with
    `halo` neighbour rows on each side (zeros at the outer edges: the
    model pads the full grid before it is sharded, so zeros there are
    the global conv's zero padding)."""
    if halo == 0:
        return x
    if x.shape[LAT_AXIS] < halo:
        raise ValueError(f"slab of {x.shape[LAT_AXIS]} rows is shorter than the halo {halo}")
    return _HaloExchange.apply(x, halo, group)


def shard_lat(x: torch.Tensor, n_shards: int, shard_idx: int, counts=None) -> torch.Tensor:
    """Slice shard `shard_idx` of the lat axis (reference:
    domain_parallel/sharding.py shard_tensor): L = H / n rows, or with
    `counts` (rows per shard, summing to H) counts[shard_idx] rows after
    the earlier shards'; differentiable (the backward is zeros outside the
    slab)."""
    if counts is None:
        per = x.shape[LAT_AXIS] // n_shards
        return _take_lat(x, shard_idx * per, per)
    return _take_lat(x, sum(counts[:shard_idx]), counts[shard_idx])


def window_rows(rows: int, window: int, n: int) -> tuple:
    """Rows a rank of `rows` (a multiple of `window`) split on window
    boundaries over n ranks: ceil(R/n) window rows on the first R % n
    ranks, floor(R/n) on the others (R = rows / window)."""
    r = rows // window
    return tuple(window * (r // n + (1 if i < r % n else 0)) for i in range(n))


def _gather_rows(x: torch.Tensor, counts, group, dim: int) -> torch.Tensor:
    """The slabs of every rank concatenated along `dim`, slab i holding
    counts[i] rows: equal slabs in one all-gather, uneven ones padded to
    the largest first and trimmed after."""
    top = max(counts)
    if min(counts) == top:
        return D.all_gather(x, dim, group)
    pad = [0, 0] * (x.ndim - 1 - dim) + [0, top - x.shape[dim]]
    full = D.all_gather(torch.nn.functional.pad(x, pad), dim, group)
    return torch.cat([full.narrow(dim, i * top, c) for i, c in enumerate(counts)], dim=dim)


class _GatherLat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, same_downstream, counts):
        counts = tuple(counts) if counts is not None else (x.shape[dim],) * _ring(group)[0]
        ctx.group, ctx.dim, ctx.same, ctx.counts = group, dim, same_downstream, counts
        return _gather_rows(x, counts, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = _ring(ctx.group)
        counts = ctx.counts
        if not ctx.same:
            if min(counts) == max(counts):
                return D.reduce_scatter(g, ctx.dim, ctx.group), None, None, None, None
            g = D.all_reduce(g, ctx.group)
        return g.narrow(ctx.dim, sum(counts[:r]), counts[r]).contiguous(), None, None, None, None


def gather_lat(x: torch.Tensor, group=None, same_downstream: bool = False,
               dim: int = LAT_AXIS, counts=None) -> torch.Tensor:
    """The slabs of every rank of `group` concatenated along the lat axis
    (rank i's holding counts[i] rows where given, else all equal).
    Backward: a reduce-scatter of the gradient (each rank's gradient of the
    full field is its share), or with `same_downstream` (every rank computes
    the same function of the gathered field, as the loss after a model's
    last gather) this rank's rows of it."""
    return _GatherLat.apply(x, group, dim % x.ndim, same_downstream, counts)


class _Reslab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst, group):
        ctx.src, ctx.dst, ctx.group = src, dst, group
        return _resplit(x, src, dst, group)

    @staticmethod
    def backward(ctx, g):
        # each rank's gradient covers its own rows of the new split, which
        # together tile the field: gathered, they are the old split's
        return _resplit(g.contiguous(), ctx.dst, ctx.src, ctx.group), None, None, None


def _resplit(x, src, dst, group):
    n, r = _ring(group)
    whole = _gather_rows(x, src, group, x.ndim + LAT_AXIS)
    return _take_lat(whole, sum(dst[:r]), dst[r]).contiguous()


def reslab(x: torch.Tensor, src, dst, group=None) -> torch.Tensor:
    """This rank's rows of the split `dst` (rows per rank) of the field
    whose slabs, split as `src`, the ranks hold: one all-gather of the
    slabs, forward and backward."""
    if tuple(src) == tuple(dst):
        return x
    return _Reslab.apply(x, tuple(src), tuple(dst), group)


class _LatRoll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _roll_slabs(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _roll_slabs(g.contiguous(), -ctx.shift, ctx.group), None, None


def _roll_slabs(x, shift, group):
    n, r = _ring(group)
    k = abs(shift)
    if shift < 0:  # new row i is old row i + k: my first k rows go north
        send, keep = _take_lat(x, 0, k), _take_lat(x, k, x.shape[LAT_AXIS] - k)
        peer_to, peer_from = (r - 1) % n, (r + 1) % n
    else:  # new row i is old row i - k: my last k rows go south
        send, keep = _take_lat(x, -k, k), _take_lat(x, 0, x.shape[LAT_AXIS] - k)
        peer_to, peer_from = (r + 1) % n, (r - 1) % n
    recv = torch.empty_like(send)
    D.exchange([(send.contiguous(), peer_to)], [(recv, peer_from)], group)
    parts = [keep, recv] if shift < 0 else [recv, keep]
    return torch.cat(parts, dim=LAT_AXIS)


def lat_roll(x: torch.Tensor, shift: int, group=None) -> torch.Tensor:
    """torch.roll(field, shift, latitude) of the field the ranks' slabs
    make, as this rank's slab: |shift| rows pass from each rank to its
    neighbour (north for a negative shift, the first rank's to the last),
    one batch of point-to-point sends. Backward: the opposite roll."""
    n, _ = _ring(group)
    if shift == 0:
        return x
    if n == 1:
        return torch.roll(x, shift, dims=x.ndim + LAT_AXIS)
    if abs(shift) > x.shape[LAT_AXIS]:
        raise ValueError(f"a roll by {shift} rows of a slab of {x.shape[LAT_AXIS]}")
    return _LatRoll.apply(x, shift, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, reduce_grad):
        ctx.group, ctx.reduce = group, reduce_grad
        return D.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return (D.all_reduce(g, ctx.group) if ctx.reduce else g), None, None


def all_reduce_sum(x: torch.Tensor, group=None, reduce_grad: bool = True) -> torch.Tensor:
    """The sum of x over `group`. Backward: the sum of the gradients over
    the group (each rank used the sum on its own rows), or the gradient as
    it is with reduce_grad off (every rank computes the same thing
    downstream: Megatron's g)."""
    return _AllReduceSum.apply(x, group, reduce_grad)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return D.all_reduce(g, ctx.group), None


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward; backward the sum of the gradients over `group`
    (Megatron's f: the ranks use x in different head groups)."""
    return _CopyToGroup.apply(x, group)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """Identity forward; the gradient times s backward."""
    return _ScaleGrad.apply(x, s)


def distributed_group_norm_moments(x: torch.Tensor, num_groups: int, group=None):
    """Group mean and (biased) variance over this rank's slab and its
    domain peers', (B, G) each in f32 (reference: domain_parallel/layers.py
    DistributedGroupNorm). Two passes, each one all-reduce: the sums, then
    the squared deviations from the global mean."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(b, -1, num_groups, c // num_groups)
    cnt = torch.tensor(float(xg.shape[1] * xg.shape[3]), device=x.device)
    s = torch.cat([xg.sum(dim=(1, 3)).reshape(-1), cnt.reshape(1)])
    s = all_reduce_sum(s, group)
    n = s[-1]
    mean = (s[:-1] / n).reshape(b, num_groups)
    dev = ((xg - mean[:, None, :, None]) ** 2).sum(dim=(1, 3))
    var = all_reduce_sum(dev, group) / n
    return mean, var

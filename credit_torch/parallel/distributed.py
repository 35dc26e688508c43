"""Process group bootstrap and the port's collectives: port of
credit_tpu/parallel/distributed.py.

credit_tpu wires every host into one GSPMD runtime with
`jax.distributed.initialize`; the port runs one process per GPU under
`torch.distributed`, NCCL on CUDA devices and gloo on the CPU.

Entry contract (the same variables and config keys as credit_tpu, in the
same priority):
  CREDIT_COORDINATOR   host:port of process 0 (or trainer.coordinator); a
                       `file://` path or a `tcp://` URL is passed on as it is
  CREDIT_NUM_PROCESSES total process count   (or trainer.num_processes)
  CREDIT_PROCESS_ID    this process's id     (or trainer.process_id)
torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT are read where the
CREDIT_* ones are absent. A rank's device is cuda:<local rank> (LOCAL_RANK,
else the process id modulo the card count).

Every collective of the port goes through the functions below, which count
their calls by kind in `COUNTS`. Over gloo, CUDA tensors are staged through
host copies (gloo's point-to-point and reduce-scatter take CPU tensors
only), explicitly and only there.
"""

from __future__ import annotations

import collections
import datetime
import logging
import os
from typing import List, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# collective calls by kind: all_reduce, all_gather, reduce_scatter, p2p
COUNTS: collections.Counter = collections.Counter()


def _init_method(coord: str) -> str:
    return coord if "://" in coord else f"tcp://{coord}"


def local_rank() -> int:
    """This process's index on its host: LOCAL_RANK, else the rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank()


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: cuda:<local rank modulo the card count>
    for a CUDA request, the request itself otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = max(torch.cuda.device_count(), 1)
    return torch.device("cuda", local_rank() % n)


def maybe_initialize(conf: Optional[dict] = None, device="cuda") -> bool:
    """Initialize the process group when configured; idempotent. Returns
    True when the run is multi-process after the call. Reads, in priority
    order, the CREDIT_* variables, the trainer section's coordinator /
    num_processes / process_id, then torchrun's variables; with none of
    them set this is a no-op (single process). The backend is NCCL for a
    CUDA `device`, gloo for the CPU; the group's timeout is
    trainer.dist_timeout seconds (600 by default)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    t = (conf or {}).get("trainer", {}) or {}
    coord = os.environ.get("CREDIT_COORDINATOR") or t.get("coordinator")
    nproc = os.environ.get("CREDIT_NUM_PROCESSES") or t.get("num_processes")
    pid = os.environ.get("CREDIT_PROCESS_ID")
    if pid is None:
        pid = t.get("process_id")
    if not (coord and nproc is not None and pid is not None) and "WORLD_SIZE" in os.environ:
        coord = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                 f"{os.environ.get('MASTER_PORT', '29500')}")
        nproc, pid = os.environ["WORLD_SIZE"], os.environ.get("RANK", "0")
    if not (coord and nproc is not None and pid is not None):
        return False
    n, p = int(nproc), int(pid)
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = float(t.get("dist_timeout", 600))
    if dev.type == "cuda":
        os.environ.setdefault("LOCAL_RANK", str(p % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(rank_device(dev))
    logger.info("init_process_group(%s, %s, world_size=%d, rank=%d)", backend, coord, n, p)
    dist.init_process_group(backend, init_method=_init_method(str(coord)), world_size=n, rank=p,
                            timeout=datetime.timedelta(seconds=timeout))
    return n > 1


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_primary() -> bool:
    """True on the process that owns host-side singleton work (the
    schema, the CSV log, checkpoints)."""
    return rank() == 0


def barrier(name: str = "credit_barrier"):
    """All processes meet here (reference analogue: dist.barrier() at
    epoch ends); a no-op in one process."""
    if world_size() > 1:
        COUNTS["barrier"] += 1
        dist.barrier()


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _stage(t: torch.Tensor, group):
    """(tensor to hand the backend, device to copy the result back to or
    None): a host copy of a CUDA tensor under gloo."""
    if t.is_cuda and _gloo(group):
        return t.detach().cpu(), t.device
    return t, None


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of `t` over `group`, as a new tensor."""
    COUNTS["all_reduce"] += 1
    buf, back = _stage(t, group)
    buf = buf.clone() if back is None else buf
    dist.all_reduce(buf, op=op, group=group)
    return buf if back is None else buf.to(back)


def all_gather(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The tensors of every rank of `group`, equal in shape, concatenated
    along `dim` in rank order."""
    COUNTS["all_gather"] += 1
    n = dist.get_world_size(group)
    buf, back = _stage(t.contiguous(), group)
    if dim == 0 and not _gloo(group):
        out = buf.new_empty((n * buf.shape[0],) + tuple(buf.shape[1:]))
        dist.all_gather_into_tensor(out, buf, group=group)
    else:
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=group)
        out = torch.cat(parts, dim=dim)
    return out if back is None else out.to(back)


def reduce_scatter(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum over `group` of `t`, this rank's chunk of it along `dim`
    (the dim divides by the group's size)."""
    COUNTS["reduce_scatter"] += 1
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if _gloo(group):  # gloo has no reduce-scatter: the full sum, then the chunk
        buf, back = _stage(t.contiguous(), group)
        buf = buf.clone() if back is None else buf
        dist.all_reduce(buf, group=group)
        out = buf.chunk(n, dim=dim)[r].contiguous()
        return out if back is None else out.to(back)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def exchange(sends: List[tuple], recvs: List[tuple], group=None) -> None:
    """Point-to-point in one batch: sends [(tensor, group rank)], recvs
    [(buffer, group rank)] filled in place."""
    if not sends and not recvs:
        return
    COUNTS["p2p"] += 1
    stage = any(t.is_cuda for t, _ in sends + recvs) and _gloo(group)
    to_global = (lambda g: dist.get_global_rank(group, g)) if group is not None else (lambda g: g)
    ops, staged = [], []
    for t, peer in sends:
        ops.append(dist.P2POp(dist.isend, t.detach().cpu() if stage else t.contiguous(),
                              to_global(peer), group))
    for t, peer in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype) if stage else t
        staged.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, to_global(peer), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for t, buf in staged:
        if buf is not t:
            t.copy_(buf)

"""Logical process mesh (dp, tp, domain): port of credit_tpu/parallel/mesh.py.

credit_tpu builds one jax.sharding.Mesh; the port builds a
`torch.distributed.device_mesh.DeviceMesh` over the processes (one GPU
each) with the same three dims:
  dp     -- data parallel: each dp coordinate feeds its own batch rows; the
            optimizer state is sharded over it (parallel/sharding.py)
  tp     -- tensor parallel: attention heads (models/layers.py)
  domain -- latitude slabs with halo exchange (parallel/halo.py,
            parallel/context.py)

Rank order is row-major over (dp, tp, domain), as credit_tpu reshapes its
device list. Sampler contract carried over: datasets shard by the dp
coordinate only; tp and domain peers receive identical batches.
"""

from __future__ import annotations

from typing import Optional, Tuple

from credit_torch.parallel import distributed as D

AXES = ("dp", "tp", "domain")


def parse_parallelism_conf(conf: dict, n_devices: Optional[int] = None) -> Tuple[int, int, int]:
    """trainer.parallelism: {data: D|'none', tensor: T, domain: S}.
    data='none'/0 -> dp inferred as n_devices // (tp * domain). The device
    count is the process group's size (one GPU a process) unless given."""
    p = (conf.get("trainer", {}) or {}).get("parallelism", {}) or {}
    n = n_devices if n_devices is not None else D.world_size()
    tp = int(p.get("tensor", 1) or 1)
    dom = int(p.get("domain", 1) or 1)
    data = p.get("data", "none")
    if data in ("none", None, 0):
        if n % (tp * dom) != 0:
            raise ValueError(f"devices={n} not divisible by tensor*domain={tp * dom}")
        dp = n // (tp * dom)
    else:
        dp = int(data)
        if dp * tp * dom != n:
            raise ValueError(
                f"parallelism {dp}x{tp}x{dom} != device count {n} "
                f"(set data: none to infer)")
    return dp, tp, dom


class Mesh:
    """The (dp, tp, domain) DeviceMesh with the accessors the port uses:
    `shape` (axis -> size, as credit_tpu's Mesh.shape), `group(axis)` (the
    process group of this rank's peers along the axis), `coord(axis)`
    (this rank's index along it) and `device_mesh`."""

    def __init__(self, device_mesh, dp: int, tp: int, domain: int, peers=None):
        self.device_mesh = device_mesh
        self.shape = {"dp": dp, "tp": tp, "domain": domain}
        self._peers = peers

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def peers(self):
        """The group of the ranks of this rank's dp row (its tp and domain
        peers, which hold the same ZeRO-3 chunks), or None where dp or
        tp * domain is 1."""
        return self._peers

    def coord(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return "Mesh(" + ", ".join(f"{a}={self.shape[a]}" for a in AXES) + ")"


def build_mesh(dp: int = 1, tp: int = 1, domain: int = 1, device_type: Optional[str] = None
               ) -> Mesh:
    """The mesh over the initialized process group, whose size must be
    dp * tp * domain. `device_type` defaults to "cuda" under NCCL and "cpu"
    otherwise (a gloo group sharing one card moves CUDA tensors through
    host copies, parallel/distributed.py)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = dp * tp * domain
    have = D.world_size() if D.initialized() else 1
    if not D.initialized() or have != need:
        raise ValueError(f"need {need} devices, have {have}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (dp, tp, domain), mesh_dim_names=AXES)
    peers = None
    if dp > 1 and tp * domain > 1:  # every rank makes every row's group
        row = tp * domain
        groups = [dist.new_group(list(range(c * row, (c + 1) * row))) for c in range(dp)]
        peers = groups[dist.get_rank() // row]
    return Mesh(dm, dp, tp, domain, peers)


def data_parallel_coords(mesh: Mesh) -> Tuple[int, int]:
    """(dp_rank, dp_size) of this process: which slice of the dataset it
    feeds (reference: credit/parallel/mesh.py:115 data_parallel_coords).
    One process a device, so a process owns one dp row."""
    return mesh.coord("dp"), mesh.shape["dp"]

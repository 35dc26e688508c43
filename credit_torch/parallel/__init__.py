"""Parallelism: the process group, the (dp, tp, domain) mesh, ZeRO-style
optimizer-state sharding, the latitude halo exchange and ring-CRPS (port of
credit_tpu/parallel/)."""

from credit_torch.parallel.mesh import build_mesh, parse_parallelism_conf  # noqa: F401

"""Sharding validators: the port's copy of credit_tpu/parallel/validate.py.

Checks every divisibility the layout relies on and raises one aggregated,
actionable error before a step runs. `mesh` is anything with a `shape`
mapping of axis -> size (parallel.mesh.Mesh). Every registered model type
is lat-sharded; where a stage's rows do not split over the domain ranks
the models gather rather than raise, so the checks are credit_tpu's (the
padded height divides by domain: NextGen's unpadded 721 rows are refused
at domain 2, as credit_tpu refuses them), plus, for a lat-sharded model
with a `lat_split_problem(domain)` method, where its stages' rows do not
split the way its slab forward needs (the SwinV2 family's window rows).
The FF's hidden width needs no check: dims divisible by tensor make 4 dim
so, and an FF whose hidden width does not divide runs whole on every tp
rank, as credit_tpu's param_spec replicates its kernels then.
"""

from __future__ import annotations

from typing import List


def validate_sharding(conf: dict, schema=None, mesh=None,
                      model=None) -> List[str]:
    """Returns the list of problems (empty = valid); raise via
    `assert_valid_sharding` in entry paths."""
    problems: List[str] = []
    if mesh is None:
        return problems
    t = (conf.get("trainer", {}) or {})
    m = (conf.get("model", {}) or {})
    dp = mesh.shape.get("dp", 1)
    tp = mesh.shape.get("tp", 1)
    dom = mesh.shape.get("domain", 1)

    bsz = int(t.get("train_batch_size", 1))
    if dp > 1 and bsz % dp != 0:
        problems.append(f"train_batch_size={bsz} not divisible by dp={dp}")
    vsz = int(t.get("valid_batch_size", bsz))
    if dp > 1 and vsz % dp != 0:
        problems.append(f"valid_batch_size={vsz} not divisible by dp={dp}")

    h = int(m.get("image_height", 0) or 0)
    if dom > 1 and h:
        pconf = m.get("padding_conf") or {}
        if pconf.get("activate"):
            h = h + sum(pconf.get("pad_lat", (0, 0)))
        if h % dom != 0:
            problems.append(
                f"padded image_height={h} not divisible by domain={dom} "
                f"(lat slabs must be equal; adjust padding_conf.pad_lat)")

    split = getattr(model, "lat_split_problem", None)
    if dom > 1 and split is not None:
        why = split(dom)
        if why:
            problems.append(why)

    if tp > 1:
        heads = m.get("num_heads")
        if heads and int(heads) % tp != 0:
            problems.append(f"num_heads={heads} not divisible by tensor={tp}")
        dims = m.get("dim")
        if isinstance(dims, (list, tuple)):
            bad = [d for d in dims if int(d) % tp != 0]
            if bad:
                problems.append(f"model dims {bad} not divisible by "
                                f"tensor={tp} (column-parallel FFN/qkv)")
        elif dims and int(dims) % tp != 0:
            problems.append(f"model dim={dims} not divisible by tensor={tp}")
    return problems


def assert_valid_sharding(conf: dict, schema=None, mesh=None, model=None):
    problems = validate_sharding(conf, schema, mesh, model)
    if problems:
        raise ValueError(
            "invalid parallelism configuration:\n  - " +
            "\n  - ".join(problems))

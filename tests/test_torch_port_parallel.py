"""The port's parallel/ against credit_tpu's, on the CPU.

The mesh parsing, the validator, the placement rule and the dp samplers
run in this process. The collectives run in 4 spawned processes over gloo
(`torch_port_parallel_worker.py`, a FileStore under tmp_path, each rank's
group timeout 60 s, the whole launch 90 s), whose .npz files are held
against credit_tpu on its 8 virtual CPU devices: the halo exchange's
contents and gradient (credit_tpu's under shard_map), the group-norm
moments, ring-CRPS's value and gradient (make_ring_crps_loss and the dense
estimator), and the conv seams under parallel.context.explicit_halo
(size-preserving stride 1, the stride-2 space-to-depth embeds with even
and odd kernels, both transposes, and the gather path) against the
unsharded port conv and credit_tpu's convs under explicit_halo; and the
SwinV2 stage's slab moves on even and uneven slabs (the cyclic latitude
roll, the re-split, the uneven gather) against torch.roll and slicing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from credit_torch.parallel import mesh as tmesh
from credit_torch.parallel import sharding as tshard
from credit_torch.parallel import validate as tvalidate
from credit_tpu.parallel import mesh as jmesh
from credit_tpu.parallel import sharding as jshard
from credit_tpu.parallel import validate as jvalidate
from torch_port_fixtures import run_ranks, two_torch_threads  # noqa: F401
from torch_port_parallel_worker import CONV_CASES, UNEVEN

WORLD = 4


def _bench_conf():
    """TINY_MODEL_CONF with 8-wide heads (2/4/8/16 a stage: every tp of 4)."""
    import copy

    from __graft_entry__ import TINY_MODEL_CONF

    conf = copy.deepcopy(TINY_MODEL_CONF)
    conf["model"]["dim_head"] = 8
    conf["data"] = {"source": {"ERA5": {"levels": [0.0, 1.0], "variables": {
        "prognostic": {"vars_3D": ["U", "T"], "vars_2D": ["SP", "T2M"]},
        "dynamic_forcing": {"vars_2D": ["TISR"]}, "diagnostic": {"vars_2D": ["PRECIP"]}}}}}
    conf["trainer"] = {"learning_rate": 1e-4}
    return conf


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    return run_ranks("ops", WORLD, tmp_path_factory.mktemp("ops"), {"bench_conf": _bench_conf()})


def _cat(ranks, key, axis=1):
    return np.concatenate([r[key] for r in ranks], axis=axis)


# --------------------------------------------------------------- in-process
@pytest.mark.parametrize("par, n", [
    ({"data": "none", "tensor": 2, "domain": 2}, 8), ({"data": 4, "tensor": 1, "domain": 2}, 8),
    ({"data": 3, "tensor": 1, "domain": 2}, 8), ({"data": "none", "tensor": 3, "domain": 1}, 8),
    ({"domain": 4}, 4), ({}, 2)])
def test_parse_parallelism_matches_reference(par, n):
    conf = {"trainer": {"parallelism": par}}
    try:
        want = jmesh.parse_parallelism_conf(conf, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.parse_parallelism_conf(conf, n)
        assert str(got.value) == str(e)
        return
    assert tmesh.parse_parallelism_conf(conf, n) == want


class _Shape:
    def __init__(self, dp, tp, dom):
        self.shape = {"dp": dp, "tp": tp, "domain": dom}


@pytest.mark.parametrize("conf", [
    {"trainer": {"train_batch_size": 3, "valid_batch_size": 4},
     "model": {"image_height": 181, "num_heads": 3, "dim": [32, 48],
               "padding_conf": {"activate": True, "pad_lat": [1, 1]}}},
    {"trainer": {"train_batch_size": 4}, "model": {"image_height": 180, "num_heads": 4,
                                                   "dim": [32, 64]}},
    {"trainer": {"train_batch_size": 2}, "model": {"image_height": 721, "dim": 96,
                                                   "padding_conf": {"activate": True,
                                                                    "pad_lat": [39, 40]}}}])
def test_validate_sharding_matches_reference(conf):
    jm = jmesh.build_mesh(2, 2, 2)
    want = jvalidate.validate_sharding(conf, mesh=jm)
    assert tvalidate.validate_sharding(conf, mesh=_Shape(2, 2, 2)) == want
    if want:
        with pytest.raises(ValueError, match="invalid parallelism"):
            tvalidate.assert_valid_sharding(conf, mesh=_Shape(2, 2, 2))


@pytest.mark.parametrize("dims", [(2, 2, 2), (4, 1, 2), (1, 4, 1), (8, 1, 1)])
def test_param_spec_matches_reference(dims):
    """The placement rule on the CrossFormer's kinds of tensors."""
    jm = jmesh.build_mesh(*dims)
    cases = [("transformer0/short_attn0/to_qkv/kernel", (128, 384)),
             ("transformer0/long_ff0/fc1/kernel", (128, 512)),
             ("transformer0/short_attn0/to_out/kernel", (128, 128)),
             ("transformer0/long_ff0/fc2/kernel", (512, 128)),
             ("cel0/conv3/kernel", (32, 32, 67, 16)), ("up_block1/up/bias", (512,)),
             ("transformer1/short_attn0/dpb/fc0/kernel", (2, 64)), ("odd/kernel", (129, 127))]
    for path, shape in cases:
        want = tuple(jshard.param_spec(path, shape, jm))
        want = want + (None,) * (len(shape) - len(want))
        assert tshard.param_spec(path.replace("/", "."), shape, _Shape(*dims)) == want, path


def test_dp_samplers_disjoint_and_match_reference():
    """Each dp rank's init times are its stride of the shared permutation:
    disjoint, together every time of the epoch's batches, and each rank's
    batches are credit_tpu's per-row sampler's (its undercounting __len__
    kept, ROADMAP queue 3)."""
    from credit_torch.data.sampler import MultiStepSampler as T
    from credit_tpu.data.sampler import MultiStepSampler as J

    rows = []
    for r in range(2):
        t = T(40, 2, 1, 1, dp_rank=r, dp_size=2, seed=3, batches_per_epoch=4)
        j = J(40, 2, 1, 1, dp_rank=r, dp_size=2, seed=3, batches_per_epoch=4)
        t.set_epoch(1)
        j.set_epoch(1)
        got = [b.tolist() for b in t]
        assert got == [b.tolist() for b in j] and len(t) == len(j)
        rows.append({i for b in got for i in b})
    assert not rows[0] & rows[1] and len(rows[0] | rows[1]) == 16


def test_shard_batch_takes_dp_rows():
    class M(_Shape):
        def coord(self, axis):
            return 1

    b = {"x": torch.arange(8.0).reshape(4, 2), "f": None}
    got = tshard.shard_batch(b, M(2, 1, 1))
    assert got["x"].tolist() == [[4.0, 5.0], [6.0, 7.0]] and got["f"] is None
    assert tshard.batch_spec() == tuple(jshard.batch_spec())
    x = torch.arange(4 * 8.0).reshape(4, 1, 8, 1, 1)
    take = tshard.batch_sharding(M(2, 1, 2))
    assert take(x).flatten().tolist() == list(range(20, 24)) + list(range(28, 32))


def test_single_process_is_a_no_op(monkeypatch):
    from credit_torch.parallel import distributed as D

    for k in ("CREDIT_COORDINATOR", "CREDIT_NUM_PROCESSES", "CREDIT_PROCESS_ID", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert D.maybe_initialize({"trainer": {}}, "cpu") is False
    assert D.world_size() == 1 and D.is_primary() and D.rank() == 0
    D.barrier()
    assert D.rank_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="need 2 devices"):
        tmesh.build_mesh(2, 1, 1)


# --------------------------------------------------------------- 4 ranks
def _jax_mesh(dp, tp, dom):
    return jmesh.build_mesh(dp, tp, dom, jax.devices()[:dp * tp * dom])


@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_matches_reference(ops, halo):
    from jax import shard_map

    from credit_tpu.parallel.halo import halo_exchange

    x = np.random.default_rng(halo).standard_normal((2, 4 * WORLD, 6, 3)).astype(np.float32)
    ct = np.random.default_rng(10 + halo).standard_normal(
        (2, (4 + 2 * halo) * WORLD, 6, 3)).astype(np.float32)
    mesh = _jax_mesh(1, 1, WORLD)
    spec = P(None, "domain", None, None)
    f = shard_map(lambda a: halo_exchange(a, halo, "domain"), mesh=mesh, in_specs=spec,
                  out_specs=spec)
    y, vjp = jax.vjp(jax.jit(f), jnp.asarray(x))
    (g,) = vjp(jnp.asarray(ct))
    np.testing.assert_array_equal(_cat(ops, f"halo{halo}_y"), np.asarray(y))
    np.testing.assert_allclose(_cat(ops, f"halo{halo}_g"), np.asarray(g), rtol=1e-6, atol=1e-6)


def test_group_norm_moments_match_reference(ops):
    from jax import shard_map

    from credit_tpu.parallel.halo import distributed_group_norm_moments

    x = np.random.default_rng(3).standard_normal((2, 4 * WORLD, 6, 8)).astype(np.float32)
    f = shard_map(lambda a: distributed_group_norm_moments(a, 4, "domain"),
                  mesh=_jax_mesh(1, 1, WORLD), in_specs=P(None, "domain", None, None),
                  out_specs=(P(), P()), check_vma=False)
    mean, var = jax.jit(f)(jnp.asarray(x))
    for r in ops:
        np.testing.assert_allclose(r["gn_mean"], np.asarray(mean), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["gn_var"], np.asarray(var), rtol=1e-5, atol=1e-6)


def test_ring_crps_matches_reference(ops):
    """The ring's value on every rank, and its gradient (each rank's own
    member's row) against credit_tpu's make_ring_crps_loss and the dense
    estimator: 1e-5 relative."""
    from credit_tpu.parallel.ring_crps import dense_fair_crps, make_ring_crps_loss

    rng = np.random.default_rng(4)
    members = rng.standard_normal((WORLD, 5, 6)).astype(np.float32)
    target = rng.standard_normal((5, 6)).astype(np.float32)
    loss = make_ring_crps_loss(_jax_mesh(WORLD, 1, 1))
    want, g_want = jax.value_and_grad(loss)(jnp.asarray(members), jnp.asarray(target))
    dense = dense_fair_crps(jnp.asarray(members), jnp.asarray(target))
    grad = sum(r["ring_grad"] for r in ops)
    for r, rk in enumerate(ops):
        np.testing.assert_allclose(rk["ring_loss"], float(want), rtol=1e-5)
        np.testing.assert_allclose(rk["ring_registry"], float(dense), rtol=1e-5)
        np.testing.assert_allclose(rk["dense"], float(dense), rtol=1e-6)
        assert not np.any(np.delete(rk["ring_grad"], r, axis=0))  # only its own member
    np.testing.assert_allclose(grad, np.asarray(g_want), rtol=1e-5, atol=1e-7)


def test_ring_crps_loss_is_dense_without_a_group():
    from credit_torch.losses import kcrps, load_loss

    rng = np.random.default_rng(5)
    pred = torch.from_numpy(rng.standard_normal((2, 4, 3, 5)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 3, 5)).astype(np.float32))
    np.testing.assert_array_equal(load_loss("ring-crps")(y, pred).numpy(),
                                  kcrps(y, pred, biased=False).numpy())


def _conv_case(name):
    i = list(CONV_CASES).index(name)
    xshape, kshape, kind, stride, pad = CONV_CASES[name]
    rng = np.random.default_rng(100 + i)
    x = rng.standard_normal(xshape).astype(np.float32)
    k = (0.2 * rng.standard_normal(kshape)).astype(np.float32)
    b = rng.standard_normal(kshape[-1]).astype(np.float32)
    return x, k, b, kind, stride, pad


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_conv_seam_matches_unsharded_and_reference(ops, name):
    """Each rank's output rows and the input, kernel and bias gradients of
    <out, ct> (the slabs' gradients concatenated; the weight gradients
    summed over the ranks) against the unsharded port conv (1e-5) and
    credit_tpu's conv under explicit_halo on a (1, 1, 4) mesh (1e-4), in
    its pallas_convs form, whose seams are the shard_map halo rings
    (outside it credit_tpu hands the convs to GSPMD, and there its k4/p1
    transpose's kernel gradient comes out twice the unsharded one on
    XLA:CPU). The halo, space-to-depth and transpose seams gather nothing;
    the gather path gathers once forward."""
    from credit_torch.ops import conv as tconv
    from credit_tpu.ops import conv as jconv

    x, k, b, kind, stride, pad = _conv_case(name)
    tfn = tconv.conv2d if kind == "conv" else tconv.conv_transpose2d
    xt, kt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, k, b))
    ref = tfn(xt, kt, bt, stride, pad)
    ct = np.random.default_rng(7).standard_normal(tuple(ref.shape)).astype(np.float32)
    (ref * torch.from_numpy(ct)).sum().backward()
    got = {"y": _cat(ops, f"{name}_y"), "gx": _cat(ops, f"{name}_gx"),
           "gk": ops[0][f"{name}_gk"], "gb": ops[0][f"{name}_gb"]}
    want = {"y": ref.detach().numpy(), "gx": xt.grad.numpy(), "gk": kt.grad.numpy(),
            "gb": bt.grad.numpy()}
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5 * np.abs(
            want[key]).max())
    assert int(ops[0][f"{name}_gathers"]) == (1 if name.startswith("gather") else 0)

    jfn = jconv.conv2d if kind == "conv" else jconv.conv_transpose2d
    mesh = _jax_mesh(1, 1, WORLD)

    def f(a, kk, bb):
        with jconv.explicit_halo(mesh), jconv.pallas_convs(True):
            return jfn(a, kk, bb, stride, pad)

    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "domain", None, None)))
    y, vjp = jax.vjp(jax.jit(f), xs, jnp.asarray(k), jnp.asarray(b))
    jg = vjp(jnp.asarray(ct))
    for key, val in zip(("y", "gx", "gk", "gb"), (y, *jg)):
        np.testing.assert_allclose(got[key], np.asarray(val), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(val)).max())


def test_benchmarks_run_on_every_mesh(ops):
    """applications/benchmark.py on 4 ranks: benchmark_halo's slabs equal
    the unsharded stencil (f32, 1e-5) with one P2P batch a conv forward and
    one backward; benchmark_parallelism's row for every (dp, tp, domain) of
    4 ranks, the same on every rank, finite, scaling against the first; at
    tp > 1 the attention blocks' parameters and every FF block's five
    (fc1's kernel and bias, fc2's kernel, the input LN's scale and bias)
    computed a share of by each rank, none at tp 1."""
    from credit_torch.applications.benchmark import default_combos

    for r in ops:
        assert r["bench_halo_err"].max() <= 1e-5
        assert int(r["bench_halo_p2p"]) == 2
        np.testing.assert_array_equal(r["bench_rows"], ops[0]["bench_rows"])
    rows = ops[0]["bench_rows"]
    assert [tuple(int(v) for v in row[:3]) for row in rows] == default_combos(WORLD)
    assert np.all(np.isfinite(rows)) and np.all(rows[:, 3:6] > 0) and rows[0, 7] == 1.0
    want = int(ops[0]["bench_attn_params"]) + 5 * int(ops[0]["bench_ff_blocks"])
    assert int(ops[0]["bench_ff_blocks"]) == 8  # TINY_MODEL_CONF: depth 1 a stage, 2 FFs a block
    for row in rows:
        assert int(row[8]) == (0 if row[1] == 1 else want), row


def _rows(counts, r):
    return slice(sum(counts[:r]), sum(counts[:r]) + counts[r])


@pytest.mark.parametrize("tag, counts", [("even", (3,) * WORLD), ("uneven", UNEVEN)])
@pytest.mark.parametrize("shift", [-2, 1])
def test_lat_roll_matches_torch_roll(ops, tag, counts, shift):
    """Each rank's slab of the rolled field is its rows of torch.roll of
    the whole field (exact), and its gradient its rows of the cotangent
    rolled back."""
    h = sum(counts)
    x = np.random.default_rng(30).standard_normal((2, h, 5, 3)).astype(np.float32)
    ct = np.random.default_rng(31).standard_normal((2, h, 5, 3)).astype(np.float32)
    want_y, want_g = np.roll(x, shift, axis=1), np.roll(ct, -shift, axis=1)
    for r, rk in enumerate(ops):
        np.testing.assert_array_equal(rk[f"roll_{tag}{shift}_y"], want_y[:, _rows(counts, r)])
        np.testing.assert_array_equal(rk[f"roll_{tag}{shift}_g"], want_g[:, _rows(counts, r)])


def test_reslab_and_uneven_gather(ops):
    """reslab from 4 even slabs of 12 rows to (4, 4, 2, 2): each rank's
    rows, and the cotangent's rows of its even slab back; gather_lat of
    uneven slabs (3, 3, 3, 2) whole on every rank, its gradient the sum of
    every rank's cotangent rows (reduce) or this rank's own
    (same_downstream); all exact."""
    x = np.random.default_rng(32).standard_normal((2, 12, 5, 3)).astype(np.float32)
    ct = np.random.default_rng(33).standard_normal((2, 12, 5, 3)).astype(np.float32)
    for r, rk in enumerate(ops):
        np.testing.assert_array_equal(rk["reslab_y"], x[:, _rows((4, 4, 2, 2), r)])
        np.testing.assert_array_equal(rk["reslab_g"], ct[:, 3 * r:3 * r + 3])
        for same in (0, 1):
            np.testing.assert_array_equal(rk[f"gather_uneven{same}_y"], x[:, :11])
            want = ct[:, _rows(UNEVEN, r)] * (1 if same else WORLD)
            np.testing.assert_allclose(rk[f"gather_uneven{same}_g"], want, rtol=1e-6)

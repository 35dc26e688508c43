"""Parity of the port's physics blocks with credit_tpu: vertical
interpolation and the column diagnostics (physics/interp.py), the pole and
wind filters (physics/pole_filter.py, postblock/wind_filter.py),
semi-Lagrangian advection (physics/advection.py), and the postblocks and
preblocks built on them.

The same seeded numpy inputs go through the JAX function and its port
counterpart on the CPU, in f32. The columns are not trivial: surface
pressures from 6e4 to 1.05e5 Pa put pressure levels below ground, some
columns sit at exactly 1e5 Pa so that two pressure levels equal model
levels (ties of the search), the model top's interface is clamped, the
grids hold their pole rows, and the winds send departure points past
both ends of the longitudes. Unless a test says otherwise the tolerance
is 1e-5 of the reference's largest value, per channel where there are
channels: the same f32 operations in other summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu import postblock as jpb
from credit_tpu import preblock as jpre
from credit_tpu import registry as jreg
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.grid import Grid as JGrid
from credit_tpu.physics import advection as jadv
from credit_tpu.physics import interp as jinterp
from credit_tpu.physics import pole_filter as jpole
from credit_tpu.postblock import wind_filter as jwind
from credit_torch import postblock as tpb
from credit_torch import preblock as tpre
from credit_torch import registry as treg
from credit_torch.data.channels import ChannelSchema
from credit_torch.grid import Grid
from credit_torch.physics import advection as tadv
from credit_torch.physics import interp as tinterp
from credit_torch.physics import pole_filter as tpole
from credit_torch.postblock import wind_filter as twind
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

TOL = 1e-5
B, H, W, L = 2, 8, 16, 4
# interfaces top -> surface: the top one is 0 Pa (clamped to 0.57 Pa); at
# SP = 1e5 Pa the full levels are 1000.285, 14000, 45000 and 82000 Pa
A_HALF = np.array([0.0, 2000.0, 6000.0, 4000.0, 0.0], np.float32)
B_HALF = np.array([0.0, 0.0, 0.2, 0.6, 1.0], np.float32)
# other interfaces for re-leveling
A_OUT = np.array([0.0, 1000.0, 5000.0, 3000.0, 0.0], np.float32)
B_OUT = np.array([0.0, 0.05, 0.3, 0.7, 1.0], np.float32)
# from above the model's second level to below ground; 45000 and 82000
# tie with the model levels of the 1e5 Pa columns
PLEVS = [5000.0, 45000.0, 70000.0, 82000.0, 100000.0]


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _rel_by_channel(out, ref) -> float:
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    out, ref = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-30)
    return float((np.abs(out - ref).max(axis=0) / scale).max())


def _jit(fn, *args):
    """credit_tpu's side as one jitted program (op by op, each JAX primitive
    compiles on its own: several times slower here)."""
    return np.asarray(jax.jit(fn)(*args))


def _surface_pressure(rng, shape):
    sp = rng.uniform(6.0e4, 1.05e5, shape)
    sp.reshape(-1)[::5] = 1.0e5  # ties with PLEVS
    return sp.astype(np.float32)


@pytest.fixture(scope="module")
def cols():
    rng = np.random.default_rng(0)
    sp = _surface_pressure(rng, (B, H, W))
    return {
        "sp": sp,
        "t": rng.uniform(230.0, 300.0, (B, H, W, L)).astype(np.float32),
        "q": rng.uniform(0.0, 0.012, (B, H, W, L)).astype(np.float32),
        "t2": rng.uniform(240.0, 305.0, (B, H, W)).astype(np.float32),
        # flat (0), low and high ground
        "sgp": np.where(rng.uniform(size=(B, H, W)) < 0.2, 0.0,
                        rng.uniform(-100.0, 3.0e4, (B, H, W))).astype(np.float32),
        "p_full": tinterp.create_pressure_grid(torch.from_numpy(sp), A_HALF, B_HALF)[1].numpy(),
        "on_plevs": rng.standard_normal((B, H, W, len(PLEVS))).astype(np.float32),
    }


def _interp_table(mod, cat, c, z, p_out):
    """name -> (function of `mod`, numpy arguments) for each case."""
    t, q, sp, sgp, pf = c["t"], c["q"], c["sp"], c["sgp"], c["p_full"]
    return {
        "pressure_on_interfaces": (lambda s: mod.pressure_on_interfaces(s, A_HALF, B_HALF),
                                   (sp,)),
        "create_pressure_grid": (lambda s: cat(mod.create_pressure_grid(s, A_HALF, B_HALF), -1),
                                 (sp,)),
        "geopotential_hybrid": (lambda *a: mod.geopotential_hybrid(*a, A_HALF, B_HALF),
                                (sgp, sp, t, q)),
        "mslp_trenberth": (mod.mslp_trenberth, (sp, c["t2"], sgp)),
        "interp_hybrid_to_pressure": (lambda a, b: mod.interp_hybrid_to_pressure(a, b, PLEVS),
                                      (t, pf)),
        "interp_hybrid_to_pressure_linear": (
            lambda a, b: mod.interp_hybrid_to_pressure(a, b, PLEVS, False), (t, pf)),
        "interp_pressure_to_hybrid": (lambda a, b: mod.interp_pressure_to_hybrid(a, PLEVS, b),
                                      (c["on_plevs"], pf)),
        "interp_hybrid_to_hybrid": (mod.interp_hybrid_to_hybrid, (q, pf, p_out)),
        "interp_temperature_to_pressure": (
            lambda a, b, c_, d: mod.interp_temperature_to_pressure(a, b, PLEVS, c_, d),
            (t, pf, sp, sgp)),
        "interp_geopotential_to_pressure": (
            lambda a, b, c_, d, e: mod.interp_geopotential_to_pressure(a, b, PLEVS, c_, d, e),
            (z, pf, sp, sgp, t[..., -1])),
    }


def _interp_cases(c):
    """name -> (the port's function, credit_tpu's, the numpy arguments)."""
    T = torch.from_numpy
    p_out = tinterp.create_pressure_grid(T(c["sp"]), A_OUT, B_OUT)[1].numpy()
    z = tinterp.geopotential_hybrid(T(c["sgp"]), T(c["sp"]), T(c["t"]), T(c["q"]), A_HALF,
                                    B_HALF).numpy()
    ports = _interp_table(tinterp, torch.cat, c, z, p_out)
    refs = _interp_table(jinterp, jnp.concatenate, c, z, p_out)
    return {k: (ports[k][0], refs[k][0], ports[k][1]) for k in ports}


@pytest.fixture(scope="module")
def interp_refs(cols):
    """credit_tpu's outputs of every case, from one jitted program."""
    cases = _interp_cases(cols)
    refs = jax.jit(lambda args: {k: cases[k][1](*a) for k, a in args.items()})(
        {k: v[2] for k, v in cases.items()})
    return cases, {k: np.asarray(v) for k, v in refs.items()}


@pytest.mark.parametrize("name", [
    "pressure_on_interfaces", "create_pressure_grid", "geopotential_hybrid", "mslp_trenberth",
    "interp_hybrid_to_pressure", "interp_hybrid_to_pressure_linear",
    "interp_pressure_to_hybrid", "interp_hybrid_to_hybrid", "interp_temperature_to_pressure",
    "interp_geopotential_to_pressure"])
def test_interp_functions_match_reference(interp_refs, name):
    """Each function of physics/interp.py against credit_tpu's on the
    module's columns: within 1e-5 of the reference's largest value per
    output level (f32; the searches pick the same brackets, ties
    included, so only rounding differs)."""
    cases, refs = interp_refs
    port, _, args = cases[name]
    out = port(*map(torch.from_numpy, args))
    assert out.dtype == torch.float32
    assert _rel_by_channel(out.numpy(), refs[name]) < TOL, name


def test_interp_ties_and_below_ground(cols):
    """The cases the module's columns are built for: at the tied levels the
    interp returns the model level's value exactly, as credit_tpu's;
    below ground the T and geopotential extrapolations take over, and
    re-leveling onto the same levels is the identity."""
    T = torch.from_numpy
    t, sp, pf = cols["t"], cols["sp"], cols["p_full"]
    tied = sp == 1.0e5
    assert tied.sum() > 5
    out = tinterp.interp_hybrid_to_pressure(T(t), T(pf), PLEVS).numpy()
    np.testing.assert_array_equal(out[tied][:, 1], t[tied][:, 2])
    np.testing.assert_array_equal(out[tied][:, 3], t[tied][:, 3])
    below = np.asarray(PLEVS)[None] > pf[..., -1].reshape(-1, 1)
    assert 0 < below.sum() < below.size
    ext = tinterp.interp_temperature_to_pressure(T(t), T(pf), PLEVS, T(sp), T(cols["sgp"]))
    assert not np.allclose(ext.numpy().reshape(-1, len(PLEVS))[below],
                           out.reshape(-1, len(PLEVS))[below])
    same = tinterp.interp_hybrid_to_hybrid(T(t), T(pf), T(pf)).numpy()
    np.testing.assert_array_equal(same, np.asarray(jinterp.interp_hybrid_to_hybrid(t, pf, pf)))
    np.testing.assert_array_equal(same, t)


# --------------------------------------------------------------- pole filter
@pytest.fixture(scope="module")
def winds():
    rng = np.random.default_rng(1)
    u = rng.normal(5.0, 15.0, (2, 3, 17, 32)).astype(np.float32)
    v = rng.normal(0.0, 10.0, (2, 3, 17, 32)).astype(np.float32)
    return u, v


@pytest.fixture(scope="module")
def pole_refs(winds):
    """credit_tpu's DiffusionPoleFilter outputs, from one jitted program."""
    u, v = winds
    ref = jpole.DiffusionPoleFilter(JGrid.regular(17, 32), n_pole_rows=3, ramp=4)
    out = jax.jit(lambda a, b: {"filter_winds": ref.filter_winds(a, b),
                                "filter_scalar": ref.filter_scalar(a),
                                "filter_moisture": ref.filter_moisture(a),
                                "pole_lowpass_rows": jpole.pole_lowpass_rows(a, 3)})(u, v)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("name", ["sigmoid_ramp", "pole_lowpass_rows", "filter_winds",
                                  "filter_scalar", "filter_moisture"])
def test_pole_filter_matches_reference(winds, pole_refs, name):
    """physics/pole_filter.py on a 17x32 equiangular grid with its pole
    rows, (2, 3) leading dims, 3 filtered rows at each pole and a ramp of 4
    (the SHT's quadrature and tables are the port's own copy): within 1e-5
    of the reference's largest value. The filters do move the fields."""
    u, v = winds
    if name == "sigmoid_ramp":
        np.testing.assert_array_equal(tpole.sigmoid_ramp(17, 4).numpy(),
                                      np.asarray(jpole.sigmoid_ramp(17, 4)))
        return
    want = pole_refs[name]
    if name == "pole_lowpass_rows":
        out = tpole.pole_lowpass_rows(torch.from_numpy(u), 3)
        assert _rel(out.numpy(), want) < TOL
        # rows 1-3 and 14-16 filtered: the north pole row is left out, the
        # south pole row is not, as in the reference's loop
        np.testing.assert_array_equal(out.numpy()[..., [0, 4, 12, 13], :],
                                      u[..., [0, 4, 12, 13], :])
        return
    ours = tpole.DiffusionPoleFilter(Grid.regular(17, 32), n_pole_rows=3, ramp=4)
    if name == "filter_winds":
        out = ours.filter_winds(torch.from_numpy(u), torch.from_numpy(v))
        for o, w, x in zip(out, want, (u, v)):
            assert _rel(o.numpy(), w) < TOL
            assert _rel(w, x) > 1e-3
        return
    out = getattr(ours, name)(torch.from_numpy(u))
    assert _rel(out.numpy(), want) < TOL
    assert _rel(want, u) > 1e-3


# --------------------------------------------------------------- wind filter
@pytest.mark.parametrize("name", ["gauss1d", "sep_conv2d", "compute_blend_mask"])
def test_wind_filter_parts_match_reference(winds, name):
    """The filter's pieces: the Gaussian taps bitwise, the separable
    smoothing (edge-replicated in latitude, circular in longitude) and the
    blend mask within 1e-5 of the reference's largest value."""
    u, v = winds
    if name == "gauss1d":
        for sigma in (0.75, 2.0, 4.0, 8.0):
            np.testing.assert_array_equal(twind._gauss1d(sigma), jwind._gauss1d(sigma))
        return
    if name == "sep_conv2d":
        for kl, ko in ((twind._gauss1d(0.75), twind._gauss1d(4.0)),
                       (np.ones(3, np.float32), np.ones(9, np.float32)), (np.ones(1), np.ones(1))):
            out = twind._sep_conv2d(torch.from_numpy(u), kl, ko)
            assert _rel(out.numpy(), _jit(lambda a: jwind._sep_conv2d(a, kl, ko), u)) < TOL
        return
    out = twind.compute_blend_mask(torch.from_numpy(u), torch.from_numpy(v), 25.0, 9, 3, 2.0)
    ref = _jit(lambda a, b: jwind.compute_blend_mask(a, b, 25.0, 9, 3, 2.0), u, v)
    assert 0.0 < ref.mean() < 1.0
    assert _rel(out.numpy(), ref) < TOL


# --------------------------------------------------------------- advection
@pytest.fixture(scope="module")
def flow():
    rng = np.random.default_rng(2)
    g = Grid.regular(17, 32)
    return {
        "grid": g,
        "u": rng.normal(10.0, 20.0, (B, 17, 32, L)).astype(np.float32),
        "v": rng.normal(0.0, 10.0, (B, 17, 32, L)).astype(np.float32),
        "sp": _surface_pressure(rng, (B, 17, 32)),
        "tracer": rng.uniform(0.0, 0.01, (B, 17, 32, L)).astype(np.float32),
        "lat": np.deg2rad(g.lat).astype(np.float32),
    }


def _sample_bound(vol, dep_ours, dep_ref, ref) -> np.ndarray:
    """Per-point bound on |port - reference| of a trilinear sample of `vol`
    (N, H, W, L) at two sets of departure points (row, col, lev): trilinear
    interpolation in index space moves by at most the largest neighbour
    difference along an axis per unit of that axis, so the bound is the sum
    over the axes of that difference times the points' distance along it,
    the columns taken as the sampler takes them (floor-mod in f32, apart on
    the circle), plus 1e-5 of the reference's largest value for the
    rounding of the sample itself. The departure points agree to rounding
    (departure_indices), but near the poles (cos(lat) floored at 1e-4) they
    lie thousands of columns away, where one f32 rounding step is ~1e-3 of
    a column."""
    v = np.asarray(vol, np.float64)
    w = v.shape[2]
    lips = [np.abs(np.diff(v, axis=a)).max() if v.shape[a] > 1 else 0.0 for a in (1, 2, 3)]
    lips[1] = max(lips[1], np.abs(v[:, :, 0] - v[:, :, -1]).max())  # the wrap
    dist = [np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
            for a, b in zip(dep_ours, dep_ref)]
    cols = [np.asarray(np.mod(np.asarray(c, np.float32), np.float32(w)), np.float64)
            for c in (dep_ours[1], dep_ref[1])]
    dist[1] = np.abs(cols[0] - cols[1])
    dist[1] = np.minimum(dist[1], w - dist[1])
    return sum(k * d for k, d in zip(lips, dist)) + TOL * np.abs(np.asarray(ref)).max()


@pytest.mark.parametrize("name", ["horizontal_divergence", "omega_from_continuity",
                                  "trilinear_sample", "departure_indices", "advect",
                                  "advect_one_level"])
def test_advection_matches_reference(flow, name):
    """physics/advection.py on a 17x32 grid with its poles and 4 levels (1
    for advect_one_level). The divergence, omega, the departure points and
    the sample at given points: within 1e-5 of the reference's largest
    value. The departure points fall past both ends of the longitudes
    (negative columns: torch.remainder is floor-mod, as jnp.mod), outside
    the rows and the levels (clamped). The reference runs op by op, as the
    port does: near the poles (cos(lat) floored at 1e-4) the departure
    points are ill-conditioned, and XLA's fused program of the same ops
    moves them by tens of columns there. The advected tracer: trilinear
    sampling is continuous in the departure point, so a floor that flips at
    an integer boundary on one side only moves the result by as much as the
    departure points differ, which is rounding: each point within
    `_sample_bound` of the points the two sides computed."""
    T = torch.from_numpy
    u, v, sp, lat = flow["u"], flow["v"], flow["sp"], flow["lat"]
    dlon = float(np.deg2rad(360.0 / 32))
    if name == "horizontal_divergence":
        out = tadv.horizontal_divergence(T(u), T(v), T(lat), dlon)
        ref = jadv.horizontal_divergence(u, v, lat, dlon)
    elif name == "omega_from_continuity":
        p_half = np.array(jinterp.pressure_on_interfaces(sp, A_HALF, B_HALF))
        out = tadv.omega_from_continuity(T(u), T(v), T(p_half), T(lat), dlon)
        ref = jadv.omega_from_continuity(u, v, p_half, lat, dlon)
    elif name == "trilinear_sample":
        rng = np.random.default_rng(3)
        pts = [rng.uniform(lo, hi, u.shape).astype(np.float32)
               for lo, hi in ((-3.0, 19.0), (-70.0, 70.0), (-1.5, 4.5))]
        assert pts[1].min() < -32 and pts[1].max() > 64
        out = tadv.trilinear_sample(T(flow["tracer"]), *map(T, pts))
        ref = jadv.trilinear_sample(flow["tracer"], *pts)
    else:
        levels = 1 if name == "advect_one_level" else L
        ab = (A_HALF[-2:], B_HALF[-2:]) if levels == 1 else (A_HALF, B_HALF)
        ours = tadv.SemiLagrangianAdvection(flow["grid"], *ab)
        theirs = jadv.SemiLagrangianAdvection(JGrid.regular(17, 32), *ab)
        uu, vv, tr = (np.ascontiguousarray(a[..., :levels]) for a in (u, v, flow["tracer"]))
        got = ours.departure_indices(T(uu), T(vv), T(sp))
        want = theirs.departure_indices(uu, vv, sp)
        if name == "departure_indices":
            assert float(want[1].min()) < 0 < float(want[1].max()) - 32
            for g_, w_ in zip(got, want):
                assert _rel(g_.numpy(), w_) < TOL
            return
        out = ours.advect([T(tr)], T(uu), T(vv), T(sp))[0]
        ref = np.asarray(theirs.advect([tr], uu, vv, sp)[0])
        assert out.dtype == torch.float32
        assert (np.abs(out.numpy() - ref) <= _sample_bound(tr, got, want, ref)).all()
        assert _rel(out.numpy(), tr) > 1e-2  # the tracer moved
        return
    assert out.dtype == torch.float32
    assert _rel(out.numpy(), ref) < TOL


def test_trilinear_sample_column_rounding_to_width():
    """A departure column just below 0 rounds to exactly the width in f32
    (torch.remainder and jnp.mod alike). That point is column 0: the port
    samples column 0 of the same row, on every row. credit_tpu's index
    then points at the next row's first column, and where that falls past
    the volume (the last two rows here) it reads NaN (ROADMAP queue 3); an
    index past the volume is an error on the card, so the port's gather
    stays inside it."""
    vol = np.random.default_rng(6).standard_normal((1, 3, 4, 2)).astype(np.float32)
    row, lev = np.meshgrid(np.arange(3.0), np.arange(2.0), indexing="ij")
    row = np.broadcast_to(row[None, :, None, :], vol.shape).astype(np.float32)
    lev = np.broadcast_to(lev[None, :, None, :], vol.shape).astype(np.float32)
    col = np.full(vol.shape, -1e-8, np.float32)
    assert float(np.mod(col[0, 0, 0, 0], np.float32(4))) == 4.0
    out = tadv.trilinear_sample(*(torch.from_numpy(np.ascontiguousarray(a))
                                  for a in (vol, row, col, lev))).numpy()
    np.testing.assert_array_equal(out, np.broadcast_to(vol[:, :, :1], vol.shape))
    ref = np.asarray(jadv.trilinear_sample(vol, row, col, lev))
    np.testing.assert_array_equal(ref[:, 0], np.broadcast_to(vol[:, 1, :1], (1, 4, 2)))
    assert np.isnan(ref[:, 1:]).all()  # its upper row's index falls past the volume


# --------------------------------------------------------------- blocks
CONF = {"data": {"source": {"ERA5": {
    "levels": list(range(L)),
    "variables": {"prognostic": {"vars_3D": ["U", "V", "T", "Q", "Z", "TP"],
                                 "vars_2D": ["SP", "VAR_2T", "U10", "V10",
                                             "mean_sea_level_pressure"]},
                  "static": {"vars_2D": ["PHIS"]}}}}}}


def _fill(entries, rng, arr):
    for e in entries:
        base = e.name.rpartition("_L")[0] or e.name
        lo, hi = {"U": (-30.0, 60.0), "V": (-30.0, 30.0), "U10": (-30.0, 60.0),
                  "V10": (-30.0, 30.0), "T": (230.0, 300.0), "TP": (230.0, 300.0),
                  "VAR_2T": (240.0, 305.0), "Q": (0.0, 0.012), "Z": (0.0, 1e5),
                  "mean_sea_level_pressure": (9e4, 1.1e5), "PHIS": (-100.0, 3e4)}.get(
                      base, (0.0, 1.0))
        arr[..., e.index] = rng.uniform(lo, hi, arr.shape[:-1])
    for name in ("SP",):
        idx = [e.index for e in entries if e.name == name]
        if idx:
            arr[..., idx[0]] = _surface_pressure(rng, arr.shape[:-1])
    return arr


@pytest.fixture(scope="module")
def blocks_env():
    schema = ChannelSchema.from_config(CONF)
    rng = np.random.default_rng(4)
    x = _fill(schema.input_entries, rng, np.zeros((B, 1, 17, 32, schema.n_input), np.float32))
    y = _fill(schema.target_entries, rng, np.zeros((B, 1, 17, 32, schema.n_target), np.float32))
    gph = rng.uniform(0.0, 3e4, (17, 32)).astype(np.float32)
    return JSchema.from_config(CONF), schema, x, y, gph


BLOCK_CONFS = {
    "mslp_diagnostic": {"temperature_var": "VAR_2T"},
    "mslp_diagnostic_from_input": {"temperature_var": "VAR_2T",
                                   "surface_geopotential_var": "PHIS"},
    "geopotential_diagnostic": {"a_half": A_HALF, "b_half": B_HALF},
    "wind_artifact_filter": {"speed_threshold": 45.0},
    "wind_artifact_filter_2d": {"U_var": "U10", "V_var": "V10", "speed_threshold": 45.0},
    "semilagrangian_advection": {"a_half": A_HALF, "b_half": B_HALF,
                                 "tracer_vars": ["Q", "T"]},
}


@pytest.mark.parametrize("name", sorted(BLOCK_CONFS))
def test_postblocks_match_reference(blocks_env, name):
    """Each new postblock built by build_postblocks from the same post_conf
    as credit_tpu's (the surface geopotential an array, or the last input
    frame's PHIS): within 1e-5 per channel of the reference, the other
    channels bitwise untouched."""
    jschema, schema, x, y, gph = blocks_env
    key = name.replace("_from_input", "").replace("_2d", "")
    sub = dict(BLOCK_CONFS[name], activate=True)
    if key in ("mslp_diagnostic", "geopotential_diagnostic") and "surface_geopotential_var" \
            not in sub:
        sub["surface_geopotential"] = gph
    conf = {"post_conf": {"activate": True, key: sub}}
    (ours,) = tpb.build_postblocks(conf, schema, Grid.regular(17, 32))
    (ref,) = jpb.build_postblocks(conf, jschema, JGrid.regular(17, 32))
    assert type(ours).__name__ == type(ref).__name__
    out = ours(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    # advection's reference runs op by op: its departure points near the
    # poles are ill-conditioned (cos(lat) floored at 1e-4), and XLA's fused
    # program rounds them otherwise than the same ops one by one, which the
    # port follows
    want = (np.asarray(ref(jnp.asarray(y), jnp.asarray(x))) if key == "semilagrangian_advection"
            else _jit(ref, y, x))
    moved = np.abs(want - y).max(axis=tuple(range(4))) > 0
    assert moved.any()
    np.testing.assert_array_equal(out[..., ~moved], y[..., ~moved])
    if key != "semilagrangian_advection":
        assert _rel_by_channel(out, want) < TOL
        return
    # the advected tracers within test_advection_matches_reference's bound
    flat = lambda view, a: np.ascontiguousarray(view.get(a).reshape(B, 17, 32, -1))  # noqa: E731
    uvs = [torch.from_numpy(flat(ours.U, y)), torch.from_numpy(flat(ours.V, y)),
           torch.from_numpy(flat(ours.sp, y)[..., 0])]
    got = ours.engine.departure_indices(*uvs)
    dep = ref.engine.departure_indices(*[u_.numpy() for u_ in uvs])
    for view in ours.tracers:
        bound = _sample_bound(flat(view, y), got, dep, flat(view, want))
        assert (np.abs(flat(view, out) - flat(view, want)) <= bound).all()


@pytest.mark.parametrize("key", ["hybrid_level_interp", "pressure_interp_diagnostic"])
def test_registry_only_postblocks_match_reference(blocks_env, key):
    """The two interp postblocks credit_tpu's build_postblocks never builds
    (they are not in its order), from the registry with the same arguments:
    T and Q re-leveled onto other hybrid levels, T onto pressure levels in
    TP, within 1e-5 per channel; build_postblocks leaves them out."""
    jschema, schema, x, y, _ = blocks_env
    kw = ({"variables": ["T", "Q"], "a_in": A_HALF[1:], "b_in": B_HALF[1:],
           "a_out": A_OUT[1:], "b_out": B_OUT[1:]} if key == "hybrid_level_interp" else
          {"input_var": "T", "output_var": "TP", "pressure_levels": PLEVS[1:],
           "a_half": A_HALF, "b_half": B_HALF})
    ours = treg.get("postblock", key)(schema=schema, grid=None, **kw)
    ref = jreg.get("postblock", key)(schema=jschema, grid=None, **kw)
    out = ours(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert _rel_by_channel(out, _jit(ref, y, x)) < TOL
    conf = {"post_conf": {"activate": True, key: {"activate": True, **kw}}}
    assert tpb.build_postblocks(conf, schema, None) == []


PREBLOCKS = {
    "hybrid_level_interp": {"variables": ["T", "Q"], "ak_in": A_HALF, "bk_in": B_HALF,
                            "ak_out": A_OUT, "bk_out": B_OUT},
    "semilagrangian_advection": {"a_half": A_HALF, "b_half": B_HALF, "tracer_vars": ["Q"],
                                 "timestep_seconds": 3600.0, "n_iterations": 3},
}


@pytest.mark.parametrize("key", sorted(PREBLOCKS))
def test_preblocks_match_reference(blocks_env, key):
    """The two physics preblocks built by build_preblocks (ic_only phase)
    from the same entry as credit_tpu's, on the input tensor: within 1e-5
    per channel, the other channels bitwise untouched."""
    jschema, schema, x, _, _ = blocks_env
    conf = {"preblocks": [{"type": key, "phase": "ic_only", **PREBLOCKS[key]}]}
    (ours,) = tpre.build_preblocks(conf, schema, phase="ic_only", grid=Grid.regular(17, 32))
    (ref,) = jpre.build_preblocks(conf, jschema, phase="ic_only", grid=JGrid.regular(17, 32))
    out = ours(torch.from_numpy(x)).numpy()
    # advection op by op: see test_postblocks_match_reference
    want = (np.asarray(ref(jnp.asarray(x))) if key == "semilagrangian_advection"
            else _jit(ref, x))
    assert _rel_by_channel(out, want) < TOL
    moved = np.abs(want - x).max(axis=tuple(range(4))) > 0
    assert moved.any()
    np.testing.assert_array_equal(out[..., ~moved], x[..., ~moved])

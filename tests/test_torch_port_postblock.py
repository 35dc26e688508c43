"""Parity of the port's Normalizer, grid, physics core, postblocks and
normalized RolloutEngine with credit_tpu.

The same numpy inputs go through the JAX function and its port counterpart
on the CPU, in f32 (summation order only: 1e-5 relative per channel).
The postblocks run on tests/test_conservation.py's environment (a 10x20
regular grid, 4 levels, its ak/bk and value ranges), with four more
diagnostics for the energy fixer's up/down form; the rollout is the tiny
CrossFormer with a Normalizer and the four fixers, against
credit_tpu.rollout.RolloutEngine with the same parameters.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import TINY_MODEL_CONF
from credit_tpu import grid as jgrid
from credit_tpu import postblock as jpb
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.data.normalize import Normalizer as JNormalizer
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.models.spectral_utils import converge_spectral
from credit_tpu.physics import core as jcore
from credit_tpu.rollout import RolloutEngine as JRolloutEngine
from credit_torch import grid as tgrid
from credit_torch import registry
from credit_torch import postblock as tpb
from credit_torch.convert_jax import from_jax_variables
from credit_torch.data.channels import ChannelSchema
from credit_torch.data.normalize import Normalizer
from credit_torch.models import load_model
from credit_torch.physics import core as tcore
from credit_torch.postblock.stochastic import apply_postblocks_stateful, init_postblock_states
from credit_torch.rollout import RolloutEngine

NLEV = 4
H, W = 10, 20
UPDOWN = ["surface_solar_down", "surface_solar_up", "surface_lw_down", "surface_lw_up"]
FIXER_DIAGNOSTICS = [
    "total_precipitation", "evaporation", "top_net_solar_radiation",
    "top_net_thermal_radiation", "surface_net_solar_radiation",
    "surface_net_thermal_radiation", "surface_sensible_heat_flux", "surface_latent_heat_flux"]
CONF = {"data": {"source": {"ERA5": {
    "levels": list(range(NLEV)),
    "variables": {"prognostic": {"vars_3D": ["U", "V", "T", "Q"], "vars_2D": ["SP"]},
                  "dynamic_forcing": {"vars_2D": ["tsi"]},
                  "diagnostic": {"vars_2D": FIXER_DIAGNOSTICS + UPDOWN}}}}}}
AK = np.array([10000.0, 5000.0, 1500.0, 0.0])
BK = np.array([0.0, 0.3, 0.8, 1.0])
TOL = 1e-5


def _fill(schema, rng, arr, entries):
    """tests/test_conservation.py's value ranges: U,V ~ 5, T ~ 270, Q ~
    0.005, SP ~ 1e5, precip/evap ~ 5e-4, tsi 100-400, other fluxes 10-100."""
    for e in entries:
        base = e.name.rpartition("_L")[0] or e.name
        if base in ("U", "V"):
            arr[..., e.index] = rng.normal(5, 2, arr.shape[:-1])
        elif base == "T":
            arr[..., e.index] = rng.normal(270, 10, arr.shape[:-1])
        elif base == "Q":
            arr[..., e.index] = rng.uniform(0.001, 0.008, arr.shape[:-1])
        elif e.name == "SP":
            arr[..., e.index] = rng.normal(1.0e5, 100, arr.shape[:-1])
        elif e.name in ("total_precipitation", "evaporation"):
            arr[..., e.index] = rng.uniform(1e-4, 1e-3, arr.shape[:-1])
        elif e.name == "tsi":
            arr[..., e.index] = rng.uniform(100, 400, arr.shape[:-1])
        else:
            arr[..., e.index] = rng.uniform(10, 100, arr.shape[:-1])
    return arr


@pytest.fixture(scope="module")
def env():
    schema = ChannelSchema.from_config(CONF)
    rng = np.random.default_rng(0)
    x = _fill(schema, rng, np.zeros((2, 1, H, W, schema.n_input), np.float32),
              schema.input_entries)
    y = _fill(schema, rng, np.zeros((2, 1, H, W, schema.n_target), np.float32),
              schema.target_entries)
    return JSchema.from_config(CONF), schema, x, y


def _rel_by_channel(out, ref) -> float:
    """Worst channel's max |out - ref| over its max |ref|."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    out, ref = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-30)
    return float((np.abs(out - ref).max(axis=0) / scale).max())


def _stats(schema, seed=1):
    """Seeded per-variable statistics: level-wise for 3-D variables, scalars
    for 2-D ones; the static channels are left out (0, 1)."""
    rng = np.random.default_rng(seed)
    base = {"U": (5, 10), "V": (5, 10), "T": (270, 15), "Q": (0.005, 0.003), "SP": (1e5, 800),
            "tsi": (250, 80), "total_precipitation": (5e-4, 3e-4), "evaporation": (5e-4, 3e-4)}
    mean, std = {}, {}
    names = {e.name.rpartition("_L")[0] or e.name for e in schema.input_entries + schema.target_entries}
    for v in sorted(names):
        m, s = base.get(v, (50, 20))
        lev = NLEV if v in ("U", "V", "T", "Q") else 1
        mean[v] = m * (1 + 0.05 * rng.standard_normal(lev))
        std[v] = s * (1 + 0.1 * rng.uniform(size=lev))
        if lev == 1:
            mean[v], std[v] = float(mean[v][0]), float(std[v][0])
    return mean, std


def _norms(jschema, schema):
    mean, std = _stats(schema)
    return (JNormalizer.from_stats_dict(jschema, mean, std),
            Normalizer.from_stats_dict(schema, mean, std))


# --------------------------------------------------------------- Normalizer
@pytest.mark.parametrize("method", ["normalize_input", "denormalize_input", "normalize_target",
                                    "denormalize_target", "normalize_forcing"])
def test_normalizer_methods_match_reference(env, method):
    jschema, schema, x, y = env
    jn, tn = _norms(jschema, schema)
    for name in ("input_mean", "input_std", "target_mean", "target_std"):
        t = getattr(tn, name)
        assert t.dtype == torch.float32 and t.dim() == 1
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jn, name)))
    arr = {"normalize_input": x, "denormalize_input": x, "normalize_target": y,
           "denormalize_target": y, "normalize_forcing": x[..., -1:]}[method]
    args = (jschema,) if method == "normalize_forcing" else ()
    ref = getattr(jn, method)(jnp.asarray(arr), *args)
    out = getattr(tn, method)(torch.from_numpy(arr), *((schema,) if args else ()))
    assert _rel_by_channel(out.numpy(), ref) < TOL


def test_normalizer_promotes_bf16_to_f32_as_reference(env):
    """bf16 with the 1-D f32 statistics is f32 in both frameworks."""
    jschema, schema, x, y = env
    jn, tn = _norms(jschema, schema)
    yb = np.array(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))
    ref = jn.denormalize_target(jnp.asarray(yb, jnp.bfloat16))
    out = tn.denormalize_target(torch.from_numpy(yb).to(torch.bfloat16))
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    assert _rel_by_channel(out.numpy(), ref) < TOL


def test_normalizer_follows_the_data_device_and_stays_put(env):
    """One Normalizer serves data on two devices: each method uses the
    statistics on its data's device and leaves the Normalizer's own
    tensors where they were."""
    _, schema, x, _ = env
    tn = Normalizer.from_stats_dict(schema, *_stats(schema))
    own = tn.input_mean
    meta = tn.normalize_input(torch.empty(x.shape, device="meta"))
    assert meta.device.type == "meta" and meta.shape == x.shape
    assert tn.input_mean is own and own.device.type == "cpu"
    cpu = tn.denormalize_input(tn.normalize_input(torch.from_numpy(x)))
    assert cpu.device.type == "cpu" and _rel_by_channel(cpu.numpy(), x) < TOL


def test_normalizer_identity_and_stats_dict_entries(env):
    jschema, schema, _, _ = env
    ji, ti = JNormalizer.identity(jschema), Normalizer.identity(schema)
    np.testing.assert_array_equal(ti.input_std.numpy(), np.asarray(ji.input_std))
    np.testing.assert_array_equal(ti.target_mean.numpy(), np.asarray(ji.target_mean))
    # level-wise arrays, one-element arrays and scalars; absent names (0, 1)
    mean = {"T": np.arange(NLEV) + 250.0, "SP": np.array([1e5]), "tsi": 300.0}
    std = {"T": np.arange(NLEV) + 10.0, "SP": 900.0}
    jn = JNormalizer.from_stats_dict(jschema, mean, std)
    tn = Normalizer.from_stats_dict(schema, mean, std)
    for name in ("input_mean", "input_std", "target_mean", "target_std"):
        np.testing.assert_array_equal(getattr(tn, name).numpy(), np.asarray(getattr(jn, name)))
    assert tn.input_mean[schema.input_names.index("T_L2")] == 252.0
    assert tn.input_std[schema.input_names.index("U_L0")] == 1.0


# --------------------------------------------------------------- grid, physics
def test_grid_matches_reference():
    for nlat, nlon, desc in [(10, 20, True), (7, 12, False), (181, 360, True)]:
        jg = jgrid.Grid.regular(nlat, nlon, levels=list(range(3)), ak=[0, 1, 2], bk=[0, .5, 1],
                                descending_lat=desc)
        tg = tgrid.Grid.regular(nlat, nlon, levels=list(range(3)), ak=[0, 1, 2], bk=[0, .5, 1],
                                descending_lat=desc)
        np.testing.assert_array_equal(tg.coslat_weights(), jg.coslat_weights())
        np.testing.assert_array_equal(tg.coslat_weights(False), jg.coslat_weights(False))
        np.testing.assert_array_equal(tg.cell_area(), jg.cell_area())
        sp = np.random.default_rng(nlat).normal(1e5, 100, (2, nlat, nlon)).astype(np.float32)
        np.testing.assert_allclose(tg.pressure_interfaces(torch.from_numpy(sp)).numpy(),
                                   np.asarray(jg.pressure_interfaces(jnp.asarray(sp))), rtol=1e-6)
    conf = {"model": {"image_height": 32, "image_width": 64},
            "data": {"source": {"ERA5": {"levels": [1, 2]}}}}
    assert tgrid.grid_from_conf(conf).shape == jgrid.grid_from_conf(conf).shape == (32, 64)
    conf = {"data": {"source": {"ERA5": {"resolution": "64x32"}}}}
    np.testing.assert_array_equal(tgrid.grid_from_conf(conf).lat, jgrid.grid_from_conf(conf).lat)


def test_physics_core_functions_match_reference():
    rng = np.random.default_rng(3)
    t = rng.normal(270, 10, (2, 5, 6, NLEV)).astype(np.float32)
    q = rng.uniform(0.001, 0.01, (2, 5, 6, NLEV)).astype(np.float32)
    sp = rng.normal(1e5, 500, (2, 5, 6)).astype(np.float32)
    ak, bk = np.float32([100, 5000, 20000, 10000]), np.float32([0, 0.1, 0.5, 1.0])
    p = jcore.model_level_pressures(jnp.asarray(sp), ak, bk)
    cases = [
        (jcore.virtual_temperature(t, q), tcore.virtual_temperature(torch.tensor(t), torch.tensor(q))),
        (jcore.density(np.asarray(p), t, q),
         tcore.density(torch.tensor(np.asarray(p)), torch.tensor(t), torch.tensor(q))),
        (p, tcore.model_level_pressures(torch.tensor(sp), torch.tensor(ak), torch.tensor(bk))),
        (jcore.half_level_pressures(p), tcore.half_level_pressures(torch.tensor(np.asarray(p)))),
        (jcore.model_level_thickness(jnp.asarray(sp), ak, bk),
         tcore.model_level_thickness(torch.tensor(sp), torch.tensor(ak), torch.tensor(bk))),
        (jcore.pressure_integral_midpoint(q[..., 1:], np.diff(np.asarray(p))),
         tcore.pressure_integral_midpoint(torch.tensor(q[..., 1:]),
                                          torch.tensor(np.diff(np.asarray(p))))),
        (jcore.pressure_integral_trapz(q, np.diff(np.asarray(p))),
         tcore.pressure_integral_trapz(torch.tensor(q), torch.tensor(np.diff(np.asarray(p))))),
    ]
    for ref, out in cases:
        assert _rel_by_channel(out.numpy()[..., None], np.asarray(ref)[..., None]) < TOL


@pytest.mark.parametrize("midpoint", [False, True])
def test_physics_classes_match_reference(midpoint):
    rng = np.random.default_rng(4)
    g = tgrid.Grid.regular(H, W)
    jg = jgrid.Grid.regular(H, W)
    nk = NLEV + 1 if midpoint else NLEV
    ak = np.linspace(0, 20000, nk)[::-1].copy()
    bk = np.linspace(0, 1, nk)
    t = rng.normal(270, 10, (2, 1, H, W, NLEV)).astype(np.float32)
    q = rng.uniform(0.001, 0.01, (2, 1, H, W, NLEV)).astype(np.float32)
    u, v = (rng.normal(5, 3, (2, 1, H, W, NLEV)).astype(np.float32) for _ in range(2))
    sp = rng.normal(1e5, 500, (2, 1, H, W)).astype(np.float32)
    gph = rng.uniform(0, 3000, (H, W)).astype(np.float32)
    js = jcore.HybridSigmaPhysics(jg, ak, bk, midpoint=midpoint)
    ts = tcore.HybridSigmaPhysics(g, ak, bk, midpoint=midpoint)
    T = torch.tensor
    pairs = [(js.integral(q, sp), ts.integral(T(q), T(sp))),
             (js.total_dry_air_mass(q, sp), ts.total_dry_air_mass(T(q), T(sp))),
             (js.total_column_water(q, sp), ts.total_column_water(T(q), T(sp))),
             (js.weighted_sum(sp), ts.weighted_sum(T(sp))),
             (js.total_energy(t, q, u, v, sp, jnp.asarray(gph)),
              ts.total_energy(T(t), T(q), T(u), T(v), T(sp), T(gph)))]
    plev = np.linspace(100, 1000, nk) * 100
    jp = jcore.PressureLevelPhysics(jg, plev, midpoint=midpoint)
    tp = tcore.PressureLevelPhysics(g, plev, midpoint=midpoint)
    qq = q if not midpoint else q[..., :nk - 1]
    pairs += [(jp.total_dry_air_mass(qq), tp.total_dry_air_mass(T(qq))),
              (jp.total_column_water(qq), tp.total_column_water(T(qq)))]
    for ref, out in pairs:
        assert _rel_by_channel(out.numpy()[..., None], np.asarray(ref)[..., None]) < TOL


# --------------------------------------------------------------- postblocks
def _blocks(schema, grid_mod, mod, case):
    g = grid_mod.Grid.regular(H, W, levels=list(range(NLEV)))
    gph = np.random.default_rng(5).uniform(0, 2000, (H, W)).astype(np.float32)
    net = dict(surf_net_solar_var="surface_net_solar_radiation",
               surf_net_lw_var="surface_net_thermal_radiation")
    updown = dict(surf_down_solar_var=UPDOWN[0], surf_up_solar_var=UPDOWN[1],
                  surf_down_lw_var=UPDOWN[2], surf_up_lw_var=UPDOWN[3])
    sig = dict(ak=AK, bk=BK, midpoint=False)
    return {
        "exp": lambda: mod.ExpTransform(schema, variables=["total_precipitation", "Q"]),
        "square": lambda: mod.SquareTransform(schema, variables=["evaporation", "U"]),
        "wet_mask": lambda: mod.WetMaskSamudra(
            schema, wet_mask=(np.arange(H * W).reshape(H, W) % 3 > 0).astype(np.float32)),
        "tracer": lambda: mod.TracerFixer(schema, tracer_vars=["Q", "evaporation"],
                                          tracer_thres=[0.004, 3e-4], tracer_thres_max=[0.006, None]),
        "mass": lambda: mod.GlobalMassFixer(schema, g, **sig),
        "mass_midpoint": lambda: mod.GlobalMassFixer(
            schema, g, ak=np.append(AK, 0.0), bk=np.append(BK, 1.0), midpoint=True),
        "water": lambda: mod.GlobalWaterFixer(schema, g, **sig),
        "water_plevels": lambda: mod.GlobalWaterFixer(
            schema, g, pressure_levels=[10000.0, 30000.0, 60000.0, 90000.0], midpoint=False),
        "energy_net": lambda: mod.GlobalEnergyFixer(schema, g, surface_geopotential=gph,
                                                    **sig, **net),
        "energy_updown": lambda: mod.GlobalEnergyFixer(schema, g, surface_geopotential=gph,
                                                       **sig, **updown),
    }[case]()


@pytest.mark.parametrize("case", ["exp", "square", "wet_mask", "tracer", "mass", "mass_midpoint",
                                  "water", "water_plevels", "energy_net", "energy_updown"])
def test_postblock_matches_reference(env, case):
    jschema, schema, x, y = env
    if case == "exp":
        y = y * 1e-3  # expm1 of values the channels can hold in f32
    jb, tb = _blocks(jschema, jgrid, jpb, case), _blocks(schema, tgrid, tpb, case)
    ref = jb(jnp.asarray(y), jnp.asarray(x))
    out = tb(torch.from_numpy(y), torch.from_numpy(x))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert _rel_by_channel(out.numpy(), ref) < TOL
    assert not np.array_equal(out.numpy(), y)  # the block changed something


def test_water_fixer_dry_globe_guard(env):
    """Zero global precipitation: the ratio is 1, not 0/0, in both."""
    jschema, schema, x, y = env
    y = y.copy()
    y[..., schema.target_names.index("total_precipitation")] = 0.0
    jb, tb = _blocks(jschema, jgrid, jpb, "water"), _blocks(schema, tgrid, tpb, "water")
    ref = np.asarray(jb(jnp.asarray(y), jnp.asarray(x)))
    out = tb(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, y)
    np.testing.assert_array_equal(ref, y)


def _post_conf(ak, bk, gph, midpoint):
    sig = {"ak": ak, "bk": bk, "midpoint": midpoint}
    return {"model": {"post_conf": {
        "activate": True,
        "tracer_fixer": {"activate": True, "tracer_vars": ["Q"], "tracer_thres": 0.0},
        "global_mass_fixer": {"activate": True, **sig},
        "global_water_fixer": {"activate": True, **sig},
        "global_energy_fixer": {"activate": True, "surface_geopotential": gph,
                                "surf_net_solar_var": "surface_net_solar_radiation",
                                "surf_net_lw_var": "surface_net_thermal_radiation", **sig},
        "skebs": {"activate": False},
    }}}


def test_build_postblocks_pipeline_and_dtypes_match_reference(env):
    """The four fixers between Denorm and Renorm, in the reference's order;
    a bf16 prediction becomes f32 at Denorm and stays f32 through Renorm,
    in both; every boundary agrees."""
    jschema, schema, x, y = env
    jn, tn = _norms(jschema, schema)
    gph = np.zeros((H, W), np.float32)
    conf = _post_conf(AK, BK, gph, False)
    jblocks = jpb.build_postblocks(conf, jschema, jgrid.Grid.regular(H, W), jn)
    tblocks = tpb.build_postblocks(conf, schema, tgrid.Grid.regular(H, W), tn)
    assert [type(b).__name__ for b in tblocks] == [type(b).__name__ for b in jblocks] == [
        "Denorm", "TracerFixer", "GlobalMassFixer", "GlobalWaterFixer", "GlobalEnergyFixer",
        "Renorm"]
    yn = np.array(jn.normalize_target(jnp.asarray(y)))
    yb = np.array(jnp.asarray(yn, jnp.bfloat16).astype(jnp.float32))
    jy, ty = jnp.asarray(yb, jnp.bfloat16), torch.from_numpy(yb).to(torch.bfloat16)
    jx, tx = jn.normalize_input(jnp.asarray(x)), tn.normalize_input(torch.from_numpy(x))
    for jb, tb in zip(jblocks, tblocks):
        jy, ty = jb(jy, jx), tb(ty, tx)
        assert str(ty.dtype).split(".")[1] == str(jy.dtype) == "float32"
        assert _rel_by_channel(ty.numpy(), jy) < TOL, type(tb).__name__
    assert tpb.build_postblocks({}, schema, None) == []
    jout, _ = jax.jit(lambda y_, x_: (jpb.apply_postblocks(jblocks, y_, x_), 0))(
        jnp.asarray(yn), jx)
    tout, states = apply_postblocks_stateful(tblocks, torch.from_numpy(yn), tx, {})
    assert states == {} and _rel_by_channel(tout.numpy(), jout) < TOL


@pytest.mark.parametrize("key", ["skebs", "semilagrangian_advection", "wind_artifact_filter",
                                 "hybrid_level_interp", "pressure_interp_diagnostic",
                                 "mslp_diagnostic", "geopotential_diagnostic"])
def test_unported_postblocks_raise(env, key):
    _, schema, _, _ = env
    conf = {"post_conf": {"activate": True, key: {"activate": True}}}
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 7"):
        registry.get("postblock", key)(schema=schema, grid=None)
    if key not in ("hybrid_level_interp", "pressure_interp_diagnostic"):
        # (the reference's build_postblocks never builds those two)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpb.build_postblocks(conf, schema, None)


def test_stateful_postblocks_and_netcdf_stats_raise(env):
    _, schema, _, _ = env

    class Stateful:
        is_stateful = True

        def __call__(self, y, x):
            return y

    with pytest.raises(NotImplementedError, match="stateful"):
        init_postblock_states([Stateful()], 1)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 12"):
        Normalizer.from_netcdf(schema, "mean.nc", "std.nc")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 12"):
        tpb.WetMaskSamudra(schema, wet_mask="mask.nc")


# --------------------------------------------------------------- the rollout
TINY_LEV = 2
TINY_DATA = {"source": {"ERA5": {
    "levels": list(range(TINY_LEV)),
    "variables": {"prognostic": {"vars_3D": ["U", "V", "T", "Q"], "vars_2D": ["SP"]},
                  "dynamic_forcing": {"vars_2D": ["tsi"]},
                  "diagnostic": {"vars_2D": FIXER_DIAGNOSTICS}}}}}


def _tiny_conf():
    conf = copy.deepcopy(TINY_MODEL_CONF)
    conf["model"].update(levels=TINY_LEV, channels=4, surface_channels=1, input_only_channels=1,
                         output_only_channels=len(FIXER_DIAGNOSTICS))
    return {**conf, "data": TINY_DATA}


def _numpy_variables(model, x, seed: int):
    """Seeded numpy draws in the JAX model's tree (kernels he-uniform, other
    leaves small), spectral norm converged; shapes from eval_shape."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def draw(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            lim = np.sqrt(6.0 / np.prod(s.shape[:-1]))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "'u'" in name or "'v'" in name:
            v = rng.standard_normal(s.shape)
            return (v / np.linalg.norm(v)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return converge_spectral(jax.tree_util.tree_map_with_path(draw, shapes))


def test_rollout_engine_with_normalizer_and_fixers_matches_reference():
    """3 steps of RolloutEngine.run in physical units with a Normalizer,
    the four fixers and the forcing of each next step, against
    credit_tpu.rollout.RolloutEngine: every emitted prediction within 1e-4
    per channel (the f32 model's summation order, as the model tests)."""
    conf = _tiny_conf()
    jschema, schema = JSchema.from_config(conf), ChannelSchema.from_config(conf)
    mean, std = _stats(schema, seed=2)
    jn = JNormalizer.from_stats_dict(jschema, mean, std)
    tn = Normalizer.from_stats_dict(schema, mean, std)
    h, w = conf["model"]["image_height"], conf["model"]["image_width"]
    rng = np.random.default_rng(6)
    x0 = _fill(schema, rng, np.zeros((1, 1, h, w, schema.n_input), np.float32),
               schema.input_entries)
    forcing = rng.uniform(100, 400, (4, 1, 1, h, w, 1)).astype(np.float32)
    ak = np.linspace(0, 8000, TINY_LEV + 1)[::-1].copy()
    bk = np.linspace(0.2, 1, TINY_LEV + 1)
    gph = rng.uniform(0, 2000, (h, w)).astype(np.float32)
    post = _post_conf(ak, bk, gph, True)

    jmodel = jax_load_model(conf)
    variables = _numpy_variables(jmodel, np.asarray(jn.normalize_input(jnp.asarray(x0))), 7)
    jblocks = jpb.build_postblocks(post, jschema, jgrid.grid_from_conf(conf), jn)
    ref = JRolloutEngine(jmodel, variables, jschema, jn, postblocks=jblocks).run(
        x0, 3, forcing_provider=lambda s: forcing[s])

    port = load_model(conf, device="cpu")
    numpy_vars = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables)
    port.load_state_dict(from_jax_variables(numpy_vars, conf, device="cpu"))
    tblocks = tpb.build_postblocks(post, schema, tgrid.grid_from_conf(conf), tn)
    engine = RolloutEngine(port, schema, tn, postblocks=tblocks, device="cpu")
    outs = engine.run(torch.from_numpy(x0), 3, forcing_provider=lambda s: forcing[s])
    engine.close()
    assert len(outs) == len(ref) == 3
    for out, r in zip(outs, ref):
        assert out.shape == (1, 1, h, w, schema.n_target)
        assert np.isfinite(out).all()
        assert _rel_by_channel(out, r) < 1e-4
    # the prediction passed the fixers: Q was clamped at 0 before Renorm
    q = [i for i, n in enumerate(schema.target_names) if n.startswith("Q_L")]
    assert outs[-1][..., q].min() > -1e-6

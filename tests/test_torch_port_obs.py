"""Parity of the port's observation and solar-forcing sources with
credit_tpu's: the projections (credit_torch/data/projection.py), the GOES,
HRRR and MRMS granule readers (data/obs.py: tolerance matching, bands and
levels, extent crops, the catalog JSON, the three missing policies, remote
mode, the GRIB .idx helpers), the solar functions (physics/solar.py) and
the computed TISR source (data/tisr.py) on the standard and noleap
calendars, and a tiny `run_training` on a zarr store plus a `tisr` source
with a per-step `regrid` preblock against credit_tpu's Trainer.fit.

The granules are written by tests/test_obs_readers.py's helpers (seeded
numpy, credit_tpu's netCDF writer) and read by both packages. The sources
are numpy up to the batch boundary, so batches must be bitwise equal.
"""

import copy
import datetime as dt
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from credit_tpu import losses as jlosses
from credit_tpu.data import local as jlocal
from credit_tpu.data import obs as jobs
from credit_tpu.data import projection as jproj
from credit_tpu.data import tisr as jtisr
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.data.normalize import Normalizer as JNormalizer
from credit_tpu.grid import Grid as JGrid
from credit_tpu.physics import solar as jsolar
from credit_tpu.trainers import trainer as jtrainer
from credit_torch import registry
from credit_torch.data import local as tlocal
from credit_torch.data import obs as tobs
from credit_torch.data import projection as tproj
from credit_torch.data import tisr as ttisr
from credit_torch.data.channels import ChannelSchema
from credit_torch.data.timeclock import CFDatetime
from credit_torch.grid import Grid
from credit_torch.physics import solar as tsolar
from credit_torch.utils import ncio as tncio
# env is a fixture: imported, it applies here too
from tests.test_torch_port_fit import _read_log, env, port_state, port_trainer  # noqa: F401
from test_obs_readers import (GOES_CONF, H_NX, H_NY, HRRR_CONF, IDX_TEXT, MRMS_CONF, NX, NY,
                              _gap_conf, _goes_dir, _hrrr_dir, _mrms_granule)
from torch_port_fixtures import fit_conf
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

H, W = 32, 64


# --------------------------------------------------------------- projection
@pytest.mark.parametrize("case", ["pug", "off_disk", "hrrr_grid", "lambert_roundtrip",
                                  "extent_slices", "haversine"])
def test_projection_matches_reference(case):
    """The GOES-R PUG example, off-disk NaNs, the HRRR grid and its corners,
    the Lambert round trip, extent slices and the nearest grid point: equal
    to credit_tpu's within 1e-12."""
    small = {**tproj.HRRR_PARAMS, "nx": 60, "ny": 40}
    if case == "pug":
        got = tproj.goes_fixed_grid_to_latlon(np.array([-0.024052]), np.array([0.095340]))
        want = jproj.goes_fixed_grid_to_latlon(np.array([-0.024052]), np.array([0.095340]))
        np.testing.assert_allclose(got[0][0, 0], 33.846162, atol=1e-4)
        np.testing.assert_allclose(got[1][0, 0], -84.690932, atol=1e-4)
    elif case == "off_disk":
        got = tproj.goes_fixed_grid_to_latlon(np.array([0.3, 0.0]), np.array([0.3, 0.05]))
        want = jproj.goes_fixed_grid_to_latlon(np.array([0.3, 0.0]), np.array([0.3, 0.05]))
        assert np.isnan(got[0][0, 0]) and np.isfinite(got[0][1, 1])
    elif case == "hrrr_grid":
        got, want = tproj.lambert_grid_latlon(), jproj.lambert_grid_latlon()
        np.testing.assert_allclose([got[0][0, 0], got[1][0, 0]], [21.138123, -122.719528],
                                   atol=1e-5)
    elif case == "lambert_roundtrip":
        xy = tproj.lambert_forward(np.array([40.0, 25.0]), np.array([-100.0, -80.0]))
        got = (*xy, *tproj.lambert_inverse(*xy))
        jxy = jproj.lambert_forward(np.array([40.0, 25.0]), np.array([-100.0, -80.0]))
        want = (*jxy, *jproj.lambert_inverse(*jxy))
        np.testing.assert_allclose(got[2:], [[40.0, 25.0], [-100.0, -80.0]], atol=1e-9)
    elif case == "extent_slices":
        lat, lon = tproj.lambert_grid_latlon(small)
        got, want = [], []
        for ext in ({"nw": [lat[30, 10], lon[30, 10]], "se": [lat[10, 50], lon[10, 50]]},
                    [lon[5, 3], lon[20, 40], lat[5, 3], lat[20, 40]], None):
            for fn, out in ((tproj.extent_slices, got), (jproj.extent_slices, want)):
                out += [(s.start, s.stop) for s in fn(lat, lon, ext)]
        assert got[:2] == [(10, 31), (10, 51)]
    else:
        lat, lon = tproj.lambert_grid_latlon(small)
        targets = [(lat[17, 23], lon[17, 23]), (35.0, -100.0), (0.0, 0.0)]
        got = [tproj.haversine_nearest(lat, lon, *t) for t in targets]
        want = [jproj.haversine_nearest(lat, lon, *t) for t in targets]
        assert got[0] == (17, 23)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-12, atol=1e-12, equal_nan=True)
    assert tproj.HRRR_PARAMS == jproj.HRRR_PARAMS


# --------------------------------------------------------------- readers
def _pair(cls_name, conf, src, name, **kw):
    """The port's and credit_tpu's reader of one source."""
    return tuple(getattr(mod, cls_name)(schema(conf), src, conf["data"], source_name=name, **kw)
                 for mod, schema in ((tobs, ChannelSchema.from_config),
                                     (jobs, JSchema.from_config)))


def _same(ours, ref, times, n_steps=1):
    """Bitwise equal inputs, targets, forcing, batches and 2-D grids."""
    for t in times:
        assert np.array_equal(ours.input_at(t), ref.input_at(t), equal_nan=True)
        assert np.array_equal(ours.target_at(t), ref.target_at(t), equal_nan=True)
    b, r = ours.batch(times, n_steps), ref.batch(times, n_steps)
    assert set(b) == set(r)
    for k in r:
        if r[k] is not None:
            assert b[k].dtype == np.float32 and np.array_equal(b[k], r[k], equal_nan=True), k
    for a, c in zip(ours.grid_latlon(), ref.grid_latlon()):
        assert np.array_equal(a, c, equal_nan=True)
    assert np.array_equal(ours._match, ref._match) and np.array_equal(ours._have, ref._have)


def _goes(tmp_path, **src_kw):
    conf = json.loads(json.dumps(GOES_CONF))
    src = conf["data"]["source"]["G16"]
    src.update(mode="local", path=_goes_dir(tmp_path), **src_kw)
    return conf, src


@pytest.mark.parametrize("case", ["bands", "extent", "outside_tolerance", "remote"])
def test_goes_reader_matches_reference(tmp_path, case):
    """Granules 1-2 min off the clock matched within the 3-min default; two
    of three bands; a corner-extent crop; a 30-min gap raising; remote mode
    raising with the bucket's name."""
    if case == "outside_tolerance":
        conf = json.loads(json.dumps(GOES_CONF))
        src = conf["data"]["source"]["G16"]
        src.update(mode="local", path=_goes_dir(tmp_path, offsets_min=(1, 30, 2, 1)))
        with pytest.raises(ValueError, match="no granule within tolerance"):
            _pair("GOESDataset", conf, src, "G16")
        return
    if case == "remote":
        conf = json.loads(json.dumps(GOES_CONF))
        src = conf["data"]["source"]["G16"]
        src.update(mode="remote", goes_position="west")
        with pytest.raises(RuntimeError, match="noaa-goes18"):
            _pair("GOESDataset", conf, src, "G16")
        return
    conf, src = _goes(tmp_path)
    if case == "extent":
        lat, lon = tobs.GOESDataset(ChannelSchema.from_config(conf), src, conf["data"],
                                    source_name="G16").grid_latlon()
        src["extent"] = {"nw": [float(lat[7, 2]), float(lon[7, 2])],
                         "se": [float(lat[2, 9]), float(lon[2, 9])]}
    ours, ref = _pair("GOESDataset", conf, src, "G16")
    _same(ours, ref, [0, 1, 2])
    assert ours.input_at(0).shape == ((1, 6, 8, 2) if case == "extent" else (1, NY, NX, 2))


def _hrrr(tmp_path, **src_kw):
    conf = json.loads(json.dumps(HRRR_CONF))
    src = conf["data"]["source"]["HRRR"]
    src.update(mode="local", path=_hrrr_dir(tmp_path, with_latlon=src_kw.pop("latlon", False)),
               **src_kw)
    return conf, src


@pytest.mark.parametrize("case", ["wrfprs", "granule_latlon", "wrfnat", "missing_level",
                                  "unknown_product"])
def test_hrrr_reader_matches_reference(tmp_path, case):
    """Pressure levels selected by value (500 and 850 hPa of 6), the
    granule's own 2-D coordinates preferred over the Lambert parameters,
    native levels by 1-based index, a level the granule lacks and an
    unknown product raising."""
    kw = {"granule_latlon": {"latlon": True}, "wrfnat": {"product": "wrfnat", "levels": [6, 2]},
          "missing_level": {"levels": [512.0]}, "unknown_product": {"product": "wrfxyz"}}
    conf, src = _hrrr(tmp_path, **kw.get(case, {}))
    if case == "unknown_product":
        with pytest.raises(ValueError, match="unknown HRRR product"):
            _pair("HRRRDataset", conf, src, "HRRR")
        return
    ours, ref = _pair("HRRRDataset", conf, src, "HRRR")
    if case == "missing_level":
        for ds in (ours, ref):
            with pytest.raises(KeyError, match="pressure level 512"):
                ds.input_at(0)
        return
    _same(ours, ref, [0, 1])
    raw = np.asarray(ours.granule_for(0)["T"].values)
    idx = [5, 1] if case == "wrfnat" else [1, 3]
    assert ours.input_at(0).shape == (1, H_NY, H_NX, 3)
    assert np.array_equal(ours.input_at(0)[0, ..., :2], np.moveaxis(raw[idx], 0, -1))


def _mrms_dir(tmp_path, names=None):
    d = tmp_path / "mrms"
    d.mkdir()
    cat = {}
    for k in range(3):
        t = dt.datetime(2024, 6, 1) + dt.timedelta(hours=k)
        path = str(d / (names[k] if names else f"MRMS_{t:%Y%m%d-%H%M%S}.nc"))
        _mrms_granule(path, seed=k)
        cat[t.isoformat()] = path
    return str(d), cat


@pytest.mark.parametrize("case", ["extent_negative_lon", "catalog_json", "empty_extent"])
def test_mrms_reader_matches_reference(tmp_path, case):
    """A -125..-65 extent normalized to 0..360 on the regular grid; an
    explicit file_catalog_path instead of the directory scan; an extent
    that selects no cell raising."""
    conf = json.loads(json.dumps(MRMS_CONF))
    src = conf["data"]["source"]["MRMS"]
    if case == "catalog_json":
        _, cat = _mrms_dir(tmp_path, names=[f"oddname_{k}.nc" for k in range(3)])
        src["file_catalog_path"] = str(tmp_path / "catalog.json")
        with open(src["file_catalog_path"], "w") as f:
            json.dump(cat, f)
    else:
        src.update(mode="local", path=_mrms_dir(tmp_path)[0],
                   extent=[-125.0, -65.0, 25.0, 50.0] if case == "extent_negative_lon"
                   else [-10.0, 10.0, 25.0, 50.0])
    ours, ref = _pair("MRMSDataset", conf, src, "MRMS")
    if case == "empty_extent":
        for ds in (ours, ref):
            with pytest.raises(ValueError, match="selects no MRMS cells"):
                ds.input_at(0)
        return
    _same(ours, ref, [0, 1])
    if case == "extent_negative_lon":
        lat, lon = ours.grid_latlon()
        assert ours.input_at(0).shape[1:3] == lat.shape and lat.shape[0] < 12
        assert (lon >= 235 - 1e-9).all() and (lon <= 295 + 1e-9).all()


@pytest.mark.parametrize("policy", ["skip", "fill", "error", "bogus"])
def test_missing_policies_match_reference(tmp_path, policy):
    """A 6-step clock with one granule 30 min off: skip drops the windows
    that touch it, fill reads it as NaN frames, error (the default) and an
    unknown policy refuse."""
    conf, src = _gap_conf(tmp_path)
    if policy != "error":
        src["missing"] = policy
    if policy in ("error", "bogus"):
        match = "missing: skip" if policy == "error" else "error|skip|fill"
        with pytest.raises(ValueError, match=match):
            _pair("GOESDataset", conf, src, "G16")
        with pytest.raises(ValueError, match=match):
            tlocal.load_dataset(conf, ChannelSchema.from_config(conf), Grid.regular(NY, NX))
        return
    ours, ref = _pair("GOESDataset", conf, src, "G16")
    for n in (1, 2):
        assert np.array_equal(ours.valid_init_indices(n), ref.valid_init_indices(n))
    if policy == "skip":
        assert list(ours.valid_init_indices(1)) == [2, 3]
        _same(ours, ref, [2, 3])
        with pytest.raises(KeyError, match="no granule within tolerance"):
            ours.input_at(1)
    else:
        assert np.isnan(ours.input_at(1)).all()
        _same(ours, ref, [0, 1, 2])


def test_grib_idx_helpers_match_reference(tmp_path):
    """.idx parsing, variable and level selection in the requested order, a
    missing level raising, and the byte ranges read from a local file."""
    ours, ref = tobs.parse_grib_idx(IDX_TEXT), jobs.parse_grib_idx(IDX_TEXT)
    assert ours == ref and ours[-1]["byte_end"] is None and ours[0]["byte_end"] == 119
    for kw in ({"pressure_levels": [500, 250]}, {"idx_level": "2 m above ground"}, {}):
        assert (tobs.select_idx_entries(ours, "TMP", **kw)
                == jobs.select_idx_entries(ref, "TMP", **kw))
    with pytest.raises(KeyError, match="no level"):
        tobs.select_idx_entries(ours, "TMP", pressure_levels=[700])
    rng = np.random.default_rng(0)
    msgs = [rng.bytes(n) for n in (120, 140, 140, 130, 77)]
    path = tmp_path / "synthetic.grib2"
    path.write_bytes(b"".join(msgs))
    assert tobs.read_idx_ranges(str(path), ours) == msgs == jobs.read_idx_ranges(str(path), ref)
    sel = tobs.select_idx_entries(ours, "TMP", pressure_levels=[500])
    assert tobs.read_idx_ranges(str(path), sel) == [msgs[1]]


def test_obs_types_are_registered_and_clocked():
    for key, cls in (("goes", tobs.GOESDataset), ("hrrr", tobs.HRRRDataset),
                     ("HRRR", tobs.HRRRDataset), ("mrms", tobs.MRMSDataset),
                     ("tisr", ttisr.TISRDataset)):
        assert registry.get("dataset", key) is cls and key in tlocal.CLOCKED_TYPES


# --------------------------------------------------------------- solar
DAYS = np.array([1.0, 59.5, 172.0, 266.25, 365.0])


@pytest.mark.parametrize("fn", ["declination", "equation_of_time", "earth_sun_distance_factor",
                                "cos_zenith", "toa_instantaneous_flux", "tisr_accumulated"])
def test_solar_functions_match_reference(fn):
    """Each function on the same inputs (days of year, a 7x12 grid, hours,
    datetimes): bitwise equal, in float64 and in float32."""
    lat, lon = np.linspace(85.0, -85.0, 7), np.linspace(-180.0, 150.0, 12)
    when = dt.datetime(2021, 3, 20, 13, 30)
    if fn in ("declination", "equation_of_time", "earth_sun_distance_factor"):
        cases = [(DAYS,)]
    elif fn == "cos_zenith":
        cases = [(lat, lon, d, h) for d, h in ((80.0, 6.0), (172.0, 18.5), (355.0, 0.0))]
    elif fn == "toa_instantaneous_flux":
        cases = [(lat, lon, when), (lat, lon, 200.0, 9.0), (lat, lon, 200.0)]
    else:
        cases = [(lat, lon, when), (lat, lon, when, 6.0, 3, 1360.5)]
    for args in cases:
        got, want = getattr(tsolar, fn)(*args), getattr(jsolar, fn)(*args)
        assert np.array_equal(np.asarray(got), np.asarray(want))
        assert np.array_equal(np.float32(got), np.float32(want))
    assert tsolar.MEAN_TSI == jsolar.MEAN_TSI


TISR_CONF = {"data": {"source": {"SUN": {
    "dataset_type": "tisr", "variables": {"dynamic_forcing": {"vars_2D": ["tisr"]}}}},
    "start_datetime": "2020-02-27 00:00", "end_datetime": "2020-03-02 06:00", "timestep": "6h"}}


@pytest.mark.parametrize("calendar", ["standard", "noleap"])
def test_tisr_source_matches_reference(calendar):
    """TISRDataset through load_dataset on a 9x16 grid across a February's
    end: every time's field, a batch of two init times of two steps, and
    the day of year and hour of each clock time, bitwise equal; 2020's Feb
    29 is day 60 on the standard clock, Mar 1 on the noleap one."""
    conf = copy.deepcopy(TISR_CONF)
    conf["data"]["calendar"] = calendar
    conf["data"]["source"]["SUN"]["period_hours"] = 3
    ours = tlocal.load_dataset(conf, ChannelSchema.from_config(conf), Grid.regular(9, 16))
    ref = jlocal.load_dataset(conf, JSchema.from_config(conf), JGrid.regular(9, 16))
    assert isinstance(ours, ttisr.TISRDataset)
    assert len(ours) == len(ref) == (14 if calendar == "noleap" else 18)
    for t in range(len(ours)):
        assert ttisr._doy_hour(ours.time_of(t)) == jtisr._doy_hour(ref.time_of(t))
        assert np.array_equal(ours.input_at(t), ref.input_at(t))
    b, r = ours.batch([0, 5], 2), ref.batch([0, 5], 2)
    for k in r:
        assert b[k].dtype == np.float32 and np.array_equal(b[k], r[k]), k
    assert b["x"].shape == (2, 1, 9, 16, 1) and b["y"].shape == (2, 2, 9, 16, 0)
    assert ttisr._doy_hour(ours.time_of(8)) == (60, 0.0)
    if calendar == "noleap":
        assert ours.time_of(8) == CFDatetime(2020, 3, 1, 0, "noleap")
    else:
        assert ours.time_of(8) == np.datetime64("2020-02-29T00:00:00")
    with pytest.raises(ValueError, match="needs the grid"):
        ttisr.TISRDataset(ours.schema, conf["data"]["source"]["SUN"], conf["data"])


# --------------------------------------------------------------- fit
def _tisr_fit_conf(env, save_loc):
    """fit_conf's tiny CrossFormer on the zarr store with TISR taken from a
    computed `tisr` source (SUN) in both windows, its mean and std from the
    computed fields, and a per-step bilinear `regrid` preblock from a grid
    with the latitudes flipped and the longitudes shifted onto -180..180
    (equal shapes: the store's fields read as lying on that grid)."""
    conf = fit_conf(env["store"], env["stats"], save_loc, num_epoch=1)
    sun = {"dataset_type": "tisr", "variables": {"dynamic_forcing": {"vars_2D": ["TISR"]}}}
    for split in ("data", "data_valid"):
        era5 = conf[split]["source"]["ERA5"]
        era5["variables"] = {k: v for k, v in era5["variables"].items() if k != "dynamic_forcing"}
        conf[split]["source"] = {"ERA5": era5, "SUN": sun}
    grid = Grid.regular(H, W)
    conf["preblocks"] = [{"type": "regrid", "method": "bilinear",
                          "src_lat": grid.lat[::-1].tolist(),
                          "src_lon": (grid.lon - 180.0).tolist()}]
    return conf


@pytest.fixture(scope="module")
def tisr_stats(env):
    """mean.nc / std.nc with TISR's statistics taken from the computed
    fields over the training clock."""
    conf = _tisr_fit_conf(env, env["root"] / "unused")
    ds = tlocal.load_dataset(conf, ChannelSchema.from_config(conf), Grid.regular(H, W))
    fields = np.stack([ds.sources["SUN"]._field(t) for t in range(len(ds))])
    paths = []
    for kind, value in (("mean", fields.mean()), ("std", fields.std())):
        old = tncio.open_dataset(env["stats"][0 if kind == "mean" else 1])
        data_vars = {k: (old[k].dims, np.asarray(old[k].values)) for k in old.keys()}
        data_vars["TISR"] = ((), np.float32(value))
        paths.append(str(env["root"] / f"tisr_{kind}.nc"))
        tncio.Dataset(data_vars, coords={"level": np.asarray([500.0, 850.0])}).to_netcdf(
            paths[-1])
    return paths


def test_tisr_fit_with_regrid_matches_reference(env, tisr_stats, tmp_path):
    """One epoch (2 training batches of 2, 1 validation batch) of
    credit_tpu's Trainer.fit and the port's run_training path (the trainer
    from the config) on the store plus the computed TISR source, with the
    regrid preblock in the steps, from the same weights: the schema's
    channel order the same, and every training_log.csv cell but `seconds`
    within 1e-5 relative. An anomaly correlation (`acc`) is a ratio of
    sums normalised to scale 1: the f32 rounding of those sums moves it by
    about the same amount at any value, so it is held within 1e-5 of
    max(|acc|, 1); near zero a relative bound would ask for more than f32
    sums give."""
    conf = _tisr_fit_conf(env, tmp_path / "jax")
    conf["data"].update(mean_path=tisr_stats[0], std_path=tisr_stats[1])
    jschema, jgrid = JSchema.from_config(conf), JGrid.regular(H, W)
    assert ChannelSchema.from_config(conf).input_names == jschema.input_names
    assert jschema.input_names[-1] == "TISR"
    jnorm = JNormalizer.from_netcdf(jschema, *tisr_stats)
    jconf = {**conf, "trainer": {**conf["trainer"], "save_best_weights": False}}
    jt = jtrainer.Trainer(jconf, env["jmodel"], jlosses.WeightedLoss.from_config(conf, jgrid),
                          jlosses.WeightedLoss.from_config(conf, jgrid, validation=True),
                          jschema, jlocal.load_dataset(conf, jschema, jgrid),
                          jlocal.load_dataset(conf, jschema, jgrid, "valid"),
                          save_loc=conf["save_loc"], normalizer=jnorm)
    params = jax.tree_util.tree_map(jnp.asarray, env["variables"]["params"])
    jt.fit(jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        spectral=jax.tree_util.tree_map(jnp.asarray, env["variables"]["spectral"]),
        opt_state=jt.optimizer.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params)), seed=0)
    tconf = {**conf, "save_loc": str(tmp_path / "port")}
    trainer = port_trainer(tconf)
    trainer.fit(port_state(trainer, env["variables"], tconf), seed=0)
    jlog, tlog = _read_log(conf["save_loc"]), _read_log(tconf["save_loc"])
    assert tlog[0] == jlog[0] and len(tlog) == len(jlog) == 2
    for name, a, b in zip(tlog[0], tlog[1], jlog[1]):
        if name != "seconds":
            a, b = float(a), float(b)
            scale = max(abs(b), 1.0) if "_acc_" in name else max(abs(b), 1e-12)
            assert np.isfinite(a) and abs(a - b) <= 1e-5 * scale, (name, a, b)

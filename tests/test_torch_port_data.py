"""Parity of the PyTorch port's data pipeline with credit_tpu's: the zarr
reader and writer, the CF clock, the zarr ERA5 source, the synthetic and
local datasets and their dispatch, multi-source composition, the sampler,
the replay buffer, the prefetcher, netCDF IO, the config loader and the
Normalizer read from netCDF.

Every fixture is small, made from a seed with numpy under tmp_path, and
written by each package's own writer so that each package reads the
other's output. The port's modules are numpy up to the batch boundary, so
the batches must be bitwise equal.
"""

import copy
import os
import threading
import time

import numpy as np
import pytest
import torch

from credit_tpu import config as jconfig
from credit_tpu.data import local as jlocal
from credit_tpu.data import zarrlite as jzarr
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.data.era5 import ZarrSourceDataset as JZarrSource
from credit_tpu.data.multi_source import build_multi_source as j_build_multi_source
from credit_tpu.data.normalize import Normalizer as JNormalizer
from credit_tpu.data.prefetch import Prefetcher as JPrefetcher
from credit_tpu.data.replay_buffer import ReplayBuffer as JReplay
from credit_tpu.data.sampler import MultiStepSampler as JSampler
from credit_tpu.data.synthetic import SyntheticDataset as JSynthetic
from credit_tpu.data import timeclock as jclock
from credit_tpu.grid import Grid as JGrid
from credit_tpu.native import fastload as jfastload
from credit_tpu.utils import ncio as jncio
from credit_torch import config as tconfig
from credit_torch.data import local as tlocal
from credit_torch.data import timeclock as tclock
from credit_torch.data import zarrlite as tzarr
from credit_torch.data.channels import ChannelSchema
from credit_torch.data.era5 import ZarrSourceDataset
from credit_torch.data.multi_source import MultiSourceDataset, build_multi_source
from credit_torch.data.normalize import Normalizer
from credit_torch.data.prefetch import Prefetcher
from credit_torch.data.replay_buffer import ReplayBuffer
from credit_torch.data.sampler import MultiStepSampler
from credit_torch.data.synthetic import SyntheticDataset
from credit_torch.grid import Grid
from credit_torch.utils import ncio as tncio
from torch_port_fixtures import (H, STATS, VARS_3D, W, era5_data, era5_source,
                                       write_era5_store, write_stats)
from test_obs_readers import GOES_CONF, HRRR_CONF, MRMS_CONF, _goes_dir, _hrrr_dir, _mrms_granule
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

WRITERS = {"credit_tpu": jzarr.write_array, "credit_torch": tzarr.write_array}
READERS = {"credit_tpu": jzarr.open_group, "credit_torch": tzarr.open_group}
PAIRS = [("credit_tpu", "credit_torch"), ("credit_torch", "credit_tpu"),
         ("credit_torch", "credit_torch")]


@pytest.fixture(autouse=True)
def python_reference_reader(monkeypatch):
    """credit_tpu's reader decodes with its native library where that
    builds; another test file builds it with g++ into one shared path, so
    here the reference reads through its Python path (the same bytes)."""
    monkeypatch.setattr(jfastload, "available", lambda: False)


# --------------------------------------------------------------- zarr
@pytest.mark.parametrize("compressor", ["zlib", None], ids=["zlib", "uncompressed"])
@pytest.mark.parametrize("writer,reader", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_zarr_round_trip(tmp_path, writer, reader, compressor):
    """A chunked array with partial edge chunks, written by one package and
    read by the other: whole, by slices, ints and index lists; a missing
    chunk reads as the fill value (0)."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((5, 7, 9)).astype(np.float32)
    WRITERS[writer](str(tmp_path), "a", data, chunks=(2, 3, 4), compressor=compressor,
                    attrs={"units": "K"})
    arr = READERS[reader](str(tmp_path))["a"]
    assert arr.shape == data.shape and arr.chunks == (2, 3, 4) and arr.attrs == {"units": "K"}
    assert np.array_equal(arr.read(), data)
    sel = (slice(1, 5), [0, 2, 6], 4)
    assert np.array_equal(arr.read(sel), data[1:5][:, [0, 2, 6]][:, :, 4])
    assert np.array_equal(arr[3], data[3])
    os.remove(tmp_path / "a" / "2.2.2")  # the corner chunk (rows 4, cols 6, lanes 8)
    want = data.copy()
    want[4:, 6:, 8:] = 0.0
    got = {name: READERS[name](str(tmp_path))["a"].read() for name in READERS}
    assert np.array_equal(got["credit_torch"], want)
    assert np.array_equal(got["credit_tpu"], want)


def test_zarr_writer_bytes_match_reference(tmp_path):
    """The port's writer writes the reference's metadata and chunk bytes."""
    data = np.random.default_rng(1).standard_normal((3, 5)).astype(">f4")
    for name, writer in WRITERS.items():
        writer(str(tmp_path / name), "a", data, chunks=(2, 2))
    ours, ref = tmp_path / "credit_torch" / "a", tmp_path / "credit_tpu" / "a"
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    for f in os.listdir(ref):
        assert (ours / f).read_bytes() == (ref / f).read_bytes(), f
    arr = tzarr.open_group(str(tmp_path / "credit_torch"))["a"]
    assert arr.dtype == np.dtype(">f4") and np.array_equal(arr.read(), data)


def test_zarr_group_errors_and_codecs(tmp_path):
    with pytest.raises(FileNotFoundError, match="not a zarr group"):
        tzarr.open_group(str(tmp_path))
    tzarr.write_array(str(tmp_path), "a", np.zeros(3, np.float32))
    group = tzarr.open_group(str(tmp_path))
    assert "a" in group and "b" not in group
    with pytest.raises(KeyError):
        group["b"]
    with pytest.raises(IndexError):
        group["a"].read(([5],))
    raw = np.arange(6, dtype=np.float32).tobytes()
    import gzip
    import zstandard

    assert tzarr._decompress(gzip.compress(raw), {"id": "gzip"}) == raw
    assert tzarr._decompress(zstandard.ZstdCompressor().compress(raw), {"id": "zstd"}) == raw
    with pytest.raises(NotImplementedError, match="blosc"):
        tzarr._decompress(raw, {"id": "blosc"})


# --------------------------------------------------------------- clock
@pytest.mark.parametrize("calendar", ["standard", "noleap", "360_day"])
def test_timeclock_matches_reference(calendar):
    """The master clock over a February month end on each calendar: init
    times, the full clock, index lookups and windows."""
    args = ("2000-02-26", "2000-03-02T18:00", "6h", calendar)
    jc = jclock.TimeClock(*args, history_len=2, num_forecast_steps=3)
    tc = tclock.TimeClock(*args, history_len=2, num_forecast_steps=3)
    assert [str(t) for t in tc.init_times] == [str(t) for t in jc.init_times]
    assert [str(t) for t in tc.all_times] == [str(t) for t in jc.all_times]
    assert len(tc) == len(jc) and tc.dt == jc.dt
    when = str(tc.all_times[9])
    assert tc.index_of(when) == jc.index_of(when)
    assert [str(t) for t in tc.window(when, 2)] == [str(t) for t in jc.window(when, 2)]
    with pytest.raises(KeyError):
        tc.index_of("1999-01-01")
    if calendar != "standard":
        t = tclock.parse_datetime("2001-02-28T18:00", calendar) + tclock.parse_timestep("12h")
        r = jclock.parse_datetime("2001-02-28T18:00", calendar) + jclock.parse_timestep("12h")
        assert str(t) == str(r) and t.dayofyear() == r.dayofyear()


@pytest.mark.parametrize("freq", ["6h", "1D", "30min", "90 s", 3, 1.5])
def test_parse_timestep_matches_reference(freq):
    assert tclock.parse_timestep(freq) == jclock.parse_timestep(freq)


# --------------------------------------------------------------- ERA5 source
@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_zarr_source_batch_bitwise(tmp_path, writer):
    """ZarrSourceDataset.batch on a 32x64 store with 2 of 3 levels and a
    store stride of 2, two history frames and a 2-step rollout: bitwise
    equal to credit_tpu's, native float32; the clock addressing agrees."""
    store = write_era5_store(tmp_path / "era5.zarr", WRITERS[writer])
    data = era5_data(store, history_len=2, forecast_len=2)
    conf = {"data": data}
    src = data["source"]["ERA5"]
    ours = ZarrSourceDataset(ChannelSchema.from_config(conf), src, data, "ERA5",
                             history_len=2, forecast_len=2)
    ref = JZarrSource(JSchema.from_config(conf), src, data, "ERA5", history_len=2,
                      forecast_len=2)
    assert len(ours) == len(ref) == 12 and ours._stride == 2
    assert [str(t) for t in ours.init_times()] == [str(t) for t in ref.init_times()]
    assert ours.index_of("1979-01-02T00") == ref.index_of("1979-01-02T00") == 3
    b, r = ours.batch([1, 4, 6], 2), ref.batch([1, 4, 6], 2)
    assert set(b) == set(r) == {"x", "y", "forcing"}
    for k in b:
        assert b[k].dtype == np.float32 and b[k].dtype.isnative
        assert np.array_equal(b[k], r[k]), k
    assert b["x"].shape == (3, 2, H, W, 8) and b["y"].shape == (3, 2, H, W, 7)


def test_zarr_source_errors(tmp_path):
    store = write_era5_store(tmp_path / "era5.zarr", tzarr.write_array, n_times=9)
    conf = {"data": era5_data(store)}
    schema = ChannelSchema.from_config(conf)
    src = conf["data"]["source"]["ERA5"]
    with pytest.raises(ValueError, match="clock end exceeds"):
        ZarrSourceDataset(schema, src, conf["data"], "ERA5")
    with pytest.raises(ValueError, match="not on the store's time axis"):
        ZarrSourceDataset(schema, src, era5_data(store, start="1978-12-31T18",
                                                 end="1979-01-01T12"), "ERA5")
    with pytest.raises(ValueError, match="level 600"):
        ZarrSourceDataset(schema, {**src, "levels": [500.0, 600.0]},
                          era5_data(store, end="1979-01-01T12"), "ERA5")
    with pytest.raises(ValueError, match="requires store_path"):
        ZarrSourceDataset(schema, {**src, "store_path": None}, conf["data"], "ERA5")


# --------------------------------------------------------------- datasets
def test_synthetic_dataset_matches_reference():
    conf = {"data": era5_data("unused")}
    ours = SyntheticDataset(ChannelSchema.from_config(conf), Grid.regular(8, 16),
                            history_len=2, n_times=12, seed=3)
    ref = JSynthetic(JSchema.from_config(conf), JGrid.regular(8, 16), history_len=2,
                     n_times=12, seed=3)
    b, r = ours.batch([2, 5], 3), ref.batch([2, 5], 3)
    assert len(ours) == 12 and set(b) == set(r)
    for k in b:
        assert np.array_equal(b[k], r[k]), k


def _dispatch_conf(kind: str, tmp_path):
    """A config per dataset kind of load_dataset, its files written."""
    if kind == "synthetic":
        return {"data": {**era5_data("unused"), "source": {"ERA5": {
            **era5_source("unused"), "dataset_type": "synthetic"}}, "n_times": 10}, "seed": 4}
    if kind == "zarr":
        store = write_era5_store(tmp_path / "era5.zarr", tzarr.write_array)
        return {"data": era5_data(store, forecast_len=2)}
    if kind == "local":
        rng = np.random.default_rng(5)
        for i in range(6):
            np.savez(tmp_path / f"t{i:03d}.npz", U=rng.standard_normal((2, 4, 8)),
                     T=rng.standard_normal((2, 4, 8)), SP=rng.standard_normal((4, 8)),
                     T2M=rng.standard_normal((4, 8)), TISR=rng.standard_normal((4, 8)),
                     LSM=rng.standard_normal((1, 4, 8)), PRECIP=rng.standard_normal((4, 8)))
        src = {k: v for k, v in era5_source("unused").items()
               if k not in ("dataset_type", "store_path")}
        return {"data": {"source": {"ERA5": {**src, "path": str(tmp_path / "t*.npz")}}}}
    # two sources on one clock: the zarr store and a synthetic one
    store = write_era5_store(tmp_path / "era5.zarr", tzarr.write_array)
    data = era5_data(store)
    data["source"]["AUX"] = {"dataset_type": "synthetic",
                             "variables": {"prognostic": {"vars_2D": ["A1"]},
                                           "diagnostic": {"vars_2D": ["A2"]}}}
    data["n_times"] = 12
    return {"data": data}


@pytest.mark.parametrize("kind", ["synthetic", "zarr", "local", "multi"])
def test_load_dataset_dispatch_matches_reference(tmp_path, kind):
    """load_dataset routes each config to its dataset class; the batches
    equal credit_tpu's bitwise."""
    conf = _dispatch_conf(kind, tmp_path)
    grid, jgrid = Grid.regular(H, W), JGrid.regular(H, W)
    ours = tlocal.load_dataset(conf, ChannelSchema.from_config(conf), grid)
    ref = jlocal.load_dataset(conf, JSchema.from_config(conf), jgrid)
    assert type(ours).__name__ == type(ref).__name__
    assert type(ours).__module__.startswith("credit_torch.")
    b, r = ours.batch([1, 2], 1), ref.batch([1, 2], 1)
    assert set(b) == set(r)
    for k in b:
        assert np.array_equal(b[k], r[k]), k


def test_multi_source_matches_reference(tmp_path):
    """MultiSourceDataset lays each source's block out in schema order; the
    sources must share one clock."""
    conf = _dispatch_conf("multi", tmp_path)
    ours = build_multi_source(conf, ChannelSchema.from_config(conf), Grid.regular(H, W))
    ref = j_build_multi_source(conf, JSchema.from_config(conf), JGrid.regular(H, W))
    assert isinstance(ours, MultiSourceDataset) and ours.source_order == ["ERA5", "AUX"]
    for t in (0, 3):
        assert np.array_equal(ours.input_at(t), ref.input_at(t))
        assert np.array_equal(ours.target_at(t + 1), ref.target_at(t + 1))
    b, r = ours.batch([2, 0], 2), ref.batch([2, 0], 2)
    for k in r:
        assert np.array_equal(b[k], r[k]), k
    with pytest.raises(ValueError, match="clock length"):
        MultiSourceDataset(ours.schema, {"ERA5": ours.sources["ERA5"],
                                         "AUX": SyntheticDataset(ours.sources["AUX"].schema,
                                                                 Grid.regular(H, W), n_times=3)})
    with pytest.raises(KeyError, match="AUX"):
        MultiSourceDataset(ours.schema, {"ERA5": ours.sources["ERA5"]})


def _obs_conf(key: str, tmp_path) -> dict:
    """A one-source config of dataset_type `key` on granules written by
    tests/test_obs_readers.py's helpers (tisr: computed, no files)."""
    if key == "tisr":
        return {"data": {"source": {"SUN": {"dataset_type": "tisr", "variables": {
            "dynamic_forcing": {"vars_2D": ["tisr"]}}}}, "start_datetime": "1979-01-01 00:00",
            "end_datetime": "1979-01-02 00:00", "timestep": "6h"}}
    base = {"goes": GOES_CONF, "hrrr": HRRR_CONF, "HRRR": HRRR_CONF, "mrms": MRMS_CONF}[key]
    conf = copy.deepcopy(base)
    src = next(iter(conf["data"]["source"].values()))
    if key == "goes":
        src["path"] = _goes_dir(tmp_path)
    elif key == "mrms":
        src["path"] = str(tmp_path)
        for k in range(3):
            t = np.datetime64("2024-06-01T00") + np.timedelta64(k, "h")
            _mrms_granule(str(tmp_path / f"MRMS_{t.item():%Y%m%d-%H%M%S}.nc"), seed=k)
    else:
        src["path"] = _hrrr_dir(tmp_path)
    src["dataset_type"] = key
    return conf


@pytest.mark.parametrize("key", ["goes", "hrrr", "HRRR", "mrms", "tisr"])
def test_unported_dataset_types_raise(key, tmp_path):
    """The observation and solar-forcing sources, once registered to raise,
    now build through load_dataset, and each first batch equals
    credit_tpu's bitwise. credit_tpu's load_dataset cannot build an "HRRR"
    source (its CLOCKED_TYPES lacks the key it registers beside "hrrr"), so
    that one is held against its "hrrr"."""
    conf = _obs_conf(key, tmp_path)
    ours = tlocal.load_dataset(conf, ChannelSchema.from_config(conf), Grid.regular(H, W))
    jconf = copy.deepcopy(conf)
    if key == "HRRR":
        jconf["data"]["source"]["HRRR"]["dataset_type"] = "hrrr"
    ref = jlocal.load_dataset(jconf, JSchema.from_config(jconf), JGrid.regular(H, W))
    assert type(ours).__name__ == type(ref).__name__
    b, r = ours.batch([0], 1), ref.batch([0], 1)
    assert set(b) == set(r)
    for k in r:
        assert b[k].dtype == np.float32 and np.array_equal(b[k], r[k]), k


# --------------------------------------------------------------- sampler
@pytest.mark.parametrize("dp_size,bpe,shuffle", [(1, 0, True), (2, 3, True), (3, 0, False)])
def test_sampler_matches_reference(dp_size, bpe, shuffle):
    """The same init-time batches per (seed, epoch) on every dp rank, with
    and without batches_per_epoch, and from given valid indices."""
    for rank in range(dp_size):
        for valid in (None, np.arange(3, 40, 2)):
            kw = dict(n_times=50, batch_size=2, forecast_len=2, history_len=2, dp_rank=rank,
                      dp_size=dp_size, seed=7, shuffle=shuffle, batches_per_epoch=bpe,
                      valid_indices=valid)
            ours, ref = MultiStepSampler(**kw), JSampler(**kw)
            for epoch in range(3):
                ours.set_epoch(epoch)
                ref.set_epoch(epoch)
                got, want = [b.tolist() for b in ours], [b.tolist() for b in ref]
                assert got == want and len(ours) == len(ref)
    assert len(MultiStepSampler(50, 2, batches_per_epoch=3)) == 3


# --------------------------------------------------------------- replay
def test_replay_buffer_draws_match_reference():
    """The same random.Random(seed) draws: eviction, sampling and the
    batches with replayed states swapped in."""
    conf = {"data": era5_data("unused")}
    ds = SyntheticDataset(ChannelSchema.from_config(conf), Grid.regular(8, 16), n_times=20)
    jds = JSynthetic(JSchema.from_config(conf), JGrid.regular(8, 16), n_times=20)
    ours, ref = ReplayBuffer(4, 0.6, seed=9), JReplay(4, 0.6, seed=9)
    rng = np.random.default_rng(0)
    for i in range(7):
        state = rng.standard_normal((1, 8, 16, 8)).astype(np.float32)
        ours.add(i + 2, state)
        ref.add(i + 2, state)
    assert len(ours) == len(ref) == 4
    assert [t for t, _ in ours._items] == [t for t, _ in ref._items]
    for _ in range(3):
        b, r = ours.make_batch(ds, [1, 5, 9], 2), ref.make_batch(jds, [1, 5, 9], 2)
        for k in r:
            assert np.array_equal(b[k], r[k]), k
    hits = [ours.maybe_sample() for _ in range(20)]
    want = [ref.maybe_sample() for _ in range(20)]
    assert [h if h is None else h[0] for h in hits] == [h if h is None else h[0] for h in want]


# --------------------------------------------------------------- prefetch
def test_prefetcher_order_error_and_close():
    """Items come back in order computed ahead of the consumer; an error
    in the producer re-raises at the consumer after the items before it;
    close() stops a producer blocked on a full queue."""
    assert list(Prefetcher(range(20), lambda i: i * i, depth=3)) == [i * i for i in range(20)]
    assert list(JPrefetcher(range(20), lambda i: i * i, depth=3)) == [i * i for i in range(20)]

    def boom(i):
        if i == 3:
            raise RuntimeError("bad item")
        return i

    got = []
    with pytest.raises(RuntimeError, match="bad item"):
        for v in Prefetcher(range(10), boom, depth=2):
            got.append(v)
    assert got == [0, 1, 2]
    produced = []

    def slow(i):
        produced.append(i)
        return i

    pf = Prefetcher(range(1000), slow, depth=2)
    assert next(pf) == 0
    t0 = time.time()
    pf.close()
    assert not pf._thread.is_alive() and time.time() - t0 < 5.0
    assert len(produced) < 10
    with Prefetcher(iter([1, 2]), lambda i: i) as pf2:
        assert list(pf2) == [1, 2]
    assert threading.active_count() >= 1


# --------------------------------------------------------------- netCDF
@pytest.mark.parametrize("writer,reader", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_ncio_round_trip(tmp_path, writer, reader):
    """Variables with dims and attrs, coordinates, a scalar and global
    attributes, written by one package and read by the other."""
    mods = {"credit_tpu": jncio, "credit_torch": tncio}
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 3, 4)).astype(np.float32)
    sp = rng.standard_normal((3, 4))  # float64: written as float32
    ds = mods[writer].Dataset(
        {"U": mods[writer].Variable(("level", "lat", "lon"), u, {"units": "m/s"}),
         "SP": (("lat", "lon"), sp), "scale": ((), np.float32(2.5))},
        coords={"level": np.asarray([500.0, 850.0]), "lat": np.arange(3.0),
                "lon": np.arange(4.0)}, attrs={"title": "fixture"})
    path = str(tmp_path / "f.nc")
    ds.to_netcdf(path)
    back = mods[reader].open_dataset(path)
    assert "U" in back and "level" in back and back.attrs["title"] == "fixture"
    assert back["U"].dims == ("level", "lat", "lon") and back["U"].attrs["units"] == "m/s"
    assert np.array_equal(back["U"].values, u)
    assert back["SP"].values.dtype.kind == "f" and back["SP"].values.dtype.itemsize == 4
    assert np.array_equal(back["SP"].values, sp.astype(np.float32))
    assert float(np.asarray(back["scale"].values).reshape(-1)[0]) == 2.5
    assert np.array_equal(back["level"].values, [500.0, 850.0])


@pytest.mark.parametrize("writer", ["credit_tpu", "credit_torch"])
def test_normalizer_from_netcdf_matches_reference(tmp_path, writer):
    """Normalizer.from_netcdf on the same mean/std files: every statistic
    within 1e-7 of credit_tpu's (relative), in schema order."""
    mean, std = write_stats(tmp_path, {"credit_tpu": jncio, "credit_torch": tncio}[writer])
    conf = {"data": era5_data("unused")}
    ours = Normalizer.from_netcdf(ChannelSchema.from_config(conf), mean, std)
    ref = JNormalizer.from_netcdf(JSchema.from_config(conf), mean, std)
    for name in ("input_mean", "input_std", "target_mean", "target_std"):
        o, r = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(o, r, rtol=1e-7, atol=0, err_msg=name)
    assert ours.input_std.numpy()[0] != 1.0  # read, not the identity default


# --------------------------------------------------------------- config
def test_config_matches_reference(tmp_path):
    """load_config from a dict and from a YAML file, the legacy data
    schema converted, and the same validation errors as credit_tpu."""
    legacy = {"save_loc": "$HOME/run", "model": {"type": "crossformer", "levels": 2},
              "data": {"variables": ["U"], "surface_variables": ["SP"],
                       "static_variables": ["LSM"]},
              "trainer": {"learning_rate": 1e-3}}
    ours, ref = tconfig.load_config(legacy), jconfig.load_config(legacy)
    assert ours == ref and ours["data"]["source"]["ERA5"]["levels"] == [0, 1]
    assert ours["save_loc"] == os.path.expandvars("$HOME/run")
    import yaml

    path = tmp_path / "c.yml"
    path.write_text(yaml.safe_dump(legacy))
    assert tconfig.load_config(str(path)) == ref
    bad = {"model": {"image_height": 0}, "data": {"forecast_len": 0},
           "trainer": {"learning_rate": -1, "train_batch_size": 0,
                       "parallelism": {"halo": "ring"}}}
    with pytest.raises(ValueError) as e_ours:
        tconfig.load_config(bad)
    with pytest.raises(ValueError) as e_ref:
        jconfig.load_config(bad)
    assert str(e_ours.value) == str(e_ref.value)
    assert tconfig.load_config({"data": {}}, require_model=False) == {"data": {}}
    conf = copy.deepcopy(ref)
    conf["model"].update(channels=1, surface_channels=1, input_only_channels=1)
    tconfig.model_channel_check(conf, ChannelSchema.from_config(conf))
    conf["model"]["channels"] = 2
    with pytest.raises(ValueError, match="input channels"):
        tconfig.model_channel_check(conf, ChannelSchema.from_config(conf))


def test_channel_schema_save_load_matches_reference(tmp_path):
    """ChannelSchema.save writes credit_tpu's channel_schema.json; each
    package loads the other's file."""
    conf = {"data": era5_data("unused")}
    ours, ref = ChannelSchema.from_config(conf), JSchema.from_config(conf)
    p1, p2 = ours.save(str(tmp_path / "a")), ref.save(str(tmp_path / "b"))
    assert open(p1).read() == open(p2).read()
    back = ChannelSchema.load(str(tmp_path / "b"))
    assert back == ours
    jback = JSchema.load(str(tmp_path / "a"))
    assert jback.input_names == ours.input_names and jback.target_names == ours.target_names
    x = torch.arange(2 * ours.n_input, dtype=torch.float32).reshape(1, 2, ours.n_input)
    y = -torch.ones(1, 1, ours.n_target)
    assert torch.equal(back.update_x(x[:, -1:], y), ours.update_x(x[:, -1:], y))

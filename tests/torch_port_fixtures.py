"""Fixtures shared by the port's tests: a seeded ERA5-like zarr store, its
config sections and mean/std netCDF files, and the cap on PyTorch's CPU
threads. Numpy only (the writer and the netCDF module are passed in;
torch is imported inside the fixture), so the card's test files can use
them without credit_tpu.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from __graft_entry__ import TINY_MODEL_CONF

H, W = 32, 64
STORE_LEVELS = [500.0, 700.0, 850.0]
STORE_HOURS = 3  # the store is 3-hourly; the clocks below step 6 h (stride 2)
N_STORE_TIMES = 41
STATS = {"U": (0.0, 10.0), "T": (250.0, 20.0), "SP": (1e5, 1000.0), "T2M": (280.0, 15.0),
         "TISR": (300.0, 150.0), "PRECIP": (1e-4, 5e-4), "LSM": (0.3, 0.4)}
VARS_3D = ("U", "T")


def write_era5_store(root, writer, seed: int = 0, n_times: int = N_STORE_TIMES):
    """A seeded ERA5-like zarr store: (time, level, lat, lon) 3-D variables
    chunked one (time, level) slab a chunk, (time, lat, lon) 2-D ones, a
    static (lat, lon) land-sea mask, a `level` coordinate and a 3-hourly
    `time` axis in hours since 1979-01-01; values in physical units around
    STATS."""
    rng = np.random.default_rng(seed)
    root = str(root)
    for name, (m, s) in STATS.items():
        if name == "LSM":
            writer(root, name, (m + s * rng.standard_normal((H, W))).astype(np.float32))
        elif name in VARS_3D:
            data = m + s * rng.standard_normal((n_times, len(STORE_LEVELS), H, W))
            writer(root, name, data.astype(np.float32), chunks=(1, 1, H, W))
        else:
            data = m + s * rng.standard_normal((n_times, H, W))
            writer(root, name, data.astype(np.float32), chunks=(1, H, W))
    writer(root, "level", np.asarray(STORE_LEVELS), attrs={"units": "hPa"})
    writer(root, "time", np.arange(n_times, dtype=np.int64) * STORE_HOURS,
           attrs={"units": "hours since 1979-01-01", "calendar": "standard"})
    return root


def era5_source(store: str, static: bool = True) -> dict:
    variables = {"prognostic": {"vars_3D": list(VARS_3D), "vars_2D": ["SP", "T2M"]},
                 "dynamic_forcing": {"vars_2D": ["TISR"]},
                 "diagnostic": {"vars_2D": ["PRECIP"]}}
    if static:
        variables["static"] = {"vars_2D": ["LSM"]}
    return {"dataset_type": "zarr", "store_path": store, "levels": [500.0, 850.0],
            "variables": variables}


def era5_data(store: str, start="1979-01-01T06", end="1979-01-04T00", static=True, **kw) -> dict:
    return {"source": {"ERA5": era5_source(store, static)}, "start_datetime": start,
            "end_datetime": end, "timestep": "6h", **kw}


def write_stats(tmp_path, ncio, seed: int = 1):
    """Mean and std netCDF files (the reference's data.mean_path/std_path):
    3-D variables per level, 2-D ones as scalars."""
    rng = np.random.default_rng(seed)
    paths = []
    for kind in ("mean", "std"):
        data_vars = {}
        for name, (m, s) in STATS.items():
            if name in VARS_3D:
                val = (m if kind == "mean" else s) * (1 + 0.1 * rng.uniform(size=2))
                data_vars[name] = (("level",), val.astype(np.float32))
            else:
                data_vars[name] = ((), np.float32(m if kind == "mean" else s))
        path = str(tmp_path / f"{kind}.nc")
        ncio.Dataset(data_vars, coords={"level": np.asarray([500.0, 850.0])}).to_netcdf(path)
        paths.append(path)
    return paths


TRAINER = {"learning_rate": 1e-4, "weight_decay": 0.01, "grad_max_norm": 1.0,
           "train_batch_size": 2, "num_epoch": 2, "batches_per_epoch": 2,
           "valid_batches_per_epoch": 1, "use_ema": True, "ema_decay": 0.99,
           "save_best_weights": True, "log_variable_metrics": True, "prefetch": 2,
           "replay": {"capacity": 8, "probability": 0.0}}
POST_CONF = {"activate": True, "tracer_fixer": {"activate": True, "tracer_vars": ["PRECIP"],
                                                "tracer_thres": 0.0}}


def fit_conf(store, stats, save_loc, **trainer) -> dict:
    """The tiny CrossFormer on the zarr store: 2 init-time batches of 2 an
    epoch from a training window, 1 validation batch from a later one, the
    Normalizer from the netCDF statistics, a tracer fixer inside the loss."""
    data = era5_data(store, end="1979-01-02T12", static=False, forecast_len=1, history_len=1,
                     mean_path=stats[0], std_path=stats[1])
    valid = era5_data(store, start="1979-01-03T00", end="1979-01-03T18", static=False,
                      forecast_len=1, history_len=1)
    model = {**copy.deepcopy(TINY_MODEL_CONF["model"]), "post_conf": POST_CONF}
    return {"model": model, "data": data, "data_valid": valid, "save_loc": str(save_loc),
            "seed": 0, "loss": {"training_loss": "mse", "use_latitude_weights": True},
            "trainer": {**TRAINER, **trainer}}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """PyTorch's CPU kernels on at most two threads while a module's tests
    run (imported by each port test module, where it applies as an autouse
    fixture). By default every test worker spreads them over every core,
    and six workers on one host then spin on each other's cores: a tiny
    ensemble fit beside six busy processes on 8 cores runs an order of
    magnitude slower than on two threads."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_parallel_worker.py")


def jit_lowopt(fn):
    """jax.jit of fn compiled at XLA's lowest optimisation level, one
    program per argument structure and shapes: the reference programs of
    the parity tests run once or twice, and compiling them at the default
    level costs most of their time (the ops are the same)."""
    import jax

    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    cache = {}

    def call(*args):
        key = str(jax.tree_util.tree_structure(args)) + str(
            [getattr(a, "shape", None) for a in jax.tree_util.tree_leaves(args)])
        if key not in cache:
            cache[key] = jax.jit(fn).lower(*args).compile(compiler_options=opts)
        return cache[key](*args)

    return call


def start_many(world: int, tmp, runs, timeout: float = 150.0):
    """The worker's `many` scenario, each (scenario, args) of `runs` in one
    launch of `world` ranks, launched now (`start_ranks`); returns the
    call that waits and returns, per run, each rank's outputs."""
    wait = start_ranks("many", world, tmp, {"runs": [list(r) for r in runs]}, timeout=timeout)

    def outputs():
        ranks = wait()
        return [[{k.split(":", 1)[1]: v for k, v in rk.items() if k.startswith(f"{i}:")}
                 for rk in ranks] for i in range(len(runs))]

    return outputs


def run_ranks(scenario: str, world: int, tmp, args: dict, timeout: float = 90.0):
    """Launch `world` worker processes for `scenario`, wait at most
    `timeout` seconds for all (then kill them and fail), and return each
    rank's .npz as a dict."""
    return start_ranks(scenario, world, tmp, args, timeout)()


def start_ranks(scenario: str, world: int, tmp, args: dict, timeout: float = 90.0):
    """`run_ranks` in two halves: launch the workers now and return the
    call that waits for them (the `timeout` counted from the launch) and
    returns their outputs, so the caller can work meanwhile; a second call
    returns (or raises) what the first did."""
    tmp = str(tmp)
    argf = os.path.join(tmp, f"{scenario}.json")
    with open(argf, "w") as f:
        json.dump(args, f)
    store = os.path.join(tmp, f"store_{scenario}")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, os.path.join(REPO, "tests"),
                                                         os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    logs, procs = [], []
    for r in range(world):
        log = open(os.path.join(tmp, f"{scenario}_rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, WORKER, scenario, str(r), str(world),
                                       store, tmp, argf], env=env, stdout=log,
                                      stderr=subprocess.STDOUT, cwd=tmp))
    deadline = time.time() + timeout
    done = {}

    def wait():
        if "out" not in done:
            try:
                done["out"] = collect()
            except AssertionError as e:
                done["out"] = e
        if isinstance(done["out"], AssertionError):
            raise done["out"]
        return done["out"]

    def collect():
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.time(), 1.0))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            with open(os.path.join(tmp, f"{scenario}_rank{bad[0]}.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"ranks {bad} of {scenario} failed (rc "
                                 f"{[procs[r].returncode for r in bad]}):\n{tail}")
        return [dict(np.load(os.path.join(tmp, f"{scenario}_rank{r}.npz")))
                for r in range(world)]

    return wait

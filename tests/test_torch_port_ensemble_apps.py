"""Parity of the port's ensemble applications with credit_tpu's: `credit
rollout` with predict.ensemble_size > 1 (gaussian and bred members in
<init>_eNN directories), `rollout_metrics` (gaussian, spherical, bred and
model perturbations) and `ensemble_eval` over a saved tree, on the tiny
CrossFormer and the seeded zarr store of tests/test_torch_port_fit.py, f32
on the CPU.

credit_tpu's draws are replayed through the port's one seam
(`credit_torch.ensemble.noise.normal`, see
tests/test_torch_port_ensemble_gen.py). credit_tpu's Trainer.init_state
hands over the shared seeded weights (its eager flax init takes ~60 s), the
port reads them from a checkpoint. Two faults of credit_tpu's
rollout_metrics are not copied (ROADMAP queue 3): it normalizes the IC and
the forcing twice, so the parity tests run it with its RolloutEngine.run
normalizing neither (`normalize_once`), and a test shows the unpatched
rows apart; its bred members raise at three members. Its run_rollout
breeds in physical units with a normalized-space model; the port breeds in
normalized space, the same with the identity normalizer.
Tolerances: the files by diff_rollout at 1e-5; rows and member states
1e-5 relative (anomaly correlations absolute: they sit near 0).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu import rollout as jrollout
from credit_tpu.applications import ensemble_eval as jeval
from credit_tpu.applications import experiment as jexperiment
from credit_tpu.applications import rollout_metrics as jmetrics
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.data.normalize import Normalizer as JNormalizer
from credit_tpu.ensemble import bred_vector as jbred
from credit_tpu.grid import Grid as JGrid
from credit_tpu.models.spectral_utils import converge_spectral
from credit_tpu.postblock import build_postblocks as j_build_postblocks
from credit_tpu.trainers import trainer as jtrainer
from credit_torch.applications import diff_rollout, experiment, run_rollout
from credit_torch.applications import ensemble_eval
from credit_torch.applications.rollout_metrics import run_rollout_metrics
from credit_torch.data.channels import ChannelSchema
from credit_torch.ensemble import noise
from credit_torch.grid import Grid
from credit_torch.output import save_netcdf_increment
# env is a fixture: imported, it applies here too
from tests.test_torch_port_fit import _jstate, env  # noqa: F401
from tests.test_torch_port_rollout_app import _rollout_conf, _save_port_checkpoint
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

H, W = 32, 64
TOL = 1e-5


@pytest.fixture
def replay(monkeypatch):
    """replay(draws): the port's draws are `draws`, in order."""

    def install(draws):
        queue = [np.array(d, np.float32) for d in draws]

        def normal(generator, shape, dtype=torch.float32, device=None):
            d = queue.pop(0)
            assert tuple(d.shape) == tuple(shape), (d.shape, shape)
            return torch.from_numpy(d).to(device or "cpu", dtype)

        monkeypatch.setattr(noise, "normal", normal)
        return queue

    return install


@pytest.fixture
def jweights(env, monkeypatch):
    monkeypatch.setattr(jtrainer.Trainer, "init_state",
                        lambda self, rng: _jstate(env["variables"], None))


def _identity(conf):
    """conf without the mean/std files: the identity Normalizer."""
    conf["data"] = {k: v for k, v in conf["data"].items() if k not in ("mean_path", "std_path")}
    return conf


def _inits(conf):
    exp = experiment.build_data(conf)
    return exp, experiment._resolve_init_indices(conf["predict"], exp["dataset"])


def _metric_close(name, got, want, tol=TOL):
    got, want = float(got), float(want)
    scale = 1.0 if "acc" in name else max(abs(want), 1e-12)
    assert np.isfinite(got) and abs(got - want) <= tol * scale, (name, got, want)


# --------------------------------------------------------------- run_rollout
@pytest.mark.parametrize("perturbation", ["gaussian", "bred"])
def test_ensemble_rollout_matches_reference(env, tmp_path, jweights, replay, perturbation):
    """ensemble_size 3 with credit_tpu's draws replayed: gaussian members
    (perturbation_std on the physical IC, one key a member folded from
    predict.seed and t0) over two init times with the real Normalizer, and
    bred members (one mirrored pair, 2 cycles of the pure step with the
    tracer fixer) over one init time with the identity Normalizer. The same
    <init>, <init>_e01 and <init>_e02 files, every variable within 1e-5 of
    its maximum by credit_tpu's diff_rollout; the members apart from the
    control."""
    predict = {"ensemble_size": 3, "perturbation": perturbation, "perturbation_std": 0.05,
               "bred_cycles": 2, "seed": 4}
    jconf = _rollout_conf(env, tmp_path / "jax", tmp_path / "jax_out", **predict)
    conf = _rollout_conf(env, tmp_path / "port", tmp_path / "port_out", **predict)
    if perturbation == "bred":
        for c in (jconf, conf):
            _identity(c)
            c["predict"]["forecasts"]["start_hours"] = [12]
    jpaths = jexperiment.run_rollout(jconf)
    exp, inits = _inits(conf)
    shape = (1, 1, H, W, exp["schema"].n_input)
    draws = []
    for t0, _ in inits:
        base = jax.random.fold_in(jax.random.PRNGKey(4), t0)
        if perturbation == "bred":
            draws.append(jax.random.normal(jax.random.split(base)[1], shape))
        else:
            draws += [jax.random.normal(jax.random.fold_in(base, m), shape) for m in (1, 2)]
    queue = replay(draws)
    _save_port_checkpoint(conf, env["variables"])
    paths = run_rollout(conf, device="cpu")
    assert not queue
    rel = sorted(os.path.relpath(p, tmp_path / "port_out") for p in paths)
    labels = [f"1979-01-01T{h}Z" for h in ([12] if perturbation == "bred" else [12, 18])]
    assert rel == sorted(os.path.relpath(p, tmp_path / "jax_out") for p in jpaths) == sorted(
        os.path.join(d, f"pred_{d}_{f:03d}.nc") for b in labels
        for d in (b, b + "_e01", b + "_e02") for f in (6, 12))
    report = jexperiment.diff_rollout(paths, str(tmp_path / "jax_out"), rtol=TOL, atol=TOL)
    assert len(report) == len(paths) and all(r["ok"] for r in report), report
    apart = diff_rollout([p for p in paths if "_e01" in p],
                         str(tmp_path / "port_out" / labels[0]), 1e-6, 1e-6)
    assert not any(r["ok"] for r in apart)


def test_bred_members_breed_in_normalized_space(env, tmp_path, replay):
    """With the real Normalizer the port breeds where its engine runs: its
    members equal credit_tpu's generate_bred_vectors over credit_tpu's pure
    engine step (fresh states, fixed key, no forcing) from the normalized
    IC, within 1e-5; credit_tpu's run_rollout breeds from the physical IC
    and lands elsewhere (ROADMAP queue 3)."""
    predict = {"ensemble_size": 4, "perturbation": "bred", "perturbation_std": 0.05,
               "bred_cycles": 2, "seed": 1}
    conf = _rollout_conf(env, tmp_path / "port", tmp_path / "out", **predict)
    _save_port_checkpoint(conf, env["variables"])
    exp, engine = experiment._load_engine(conf, torch.device("cpu"))
    t0 = _inits(conf)[1][0][0]
    x0 = exp["dataset"].input_at(t0)[None]
    jschema = JSchema.from_config(conf)
    jnorm = JNormalizer.from_netcdf(jschema, *env["stats"])
    jvars = converge_spectral(jax.tree_util.tree_map(jnp.asarray, env["variables"]))
    jpost = j_build_postblocks(conf, jschema, JGrid.regular(H, W), jnorm)
    jengine = jrollout.RolloutEngine(env["jmodel"], jvars, jschema, jnorm, postblocks=jpost)
    states = jengine._init_states(jengine.postblocks, 1)

    def step(x):
        return jengine._step_nofrc(jengine.variables, x, states, jax.random.PRNGKey(0))[1]

    key = jax.random.fold_in(jax.random.PRNGKey(1), t0)
    xn = jnorm.normalize_input(jnp.asarray(x0))
    want = jbred.generate_bred_vectors(step, xn, key, 3, amplitude=0.05, n_cycles=2)
    physical = jbred.generate_bred_vectors(step, jnp.asarray(x0), key, 3, 0.05, 2)
    k, draws = key, []
    for _ in range(2):
        k, sub = jax.random.split(k)
        draws.append(jax.random.normal(sub, x0.shape))
    replay(draws)
    members = experiment.ensemble_members(engine, x0, conf["predict"], t0)
    assert [m[0] for m in members] == ["_e01", "_e02", "_e03"]
    assert all(m[2] for m in members)
    for (_, got, _), w, p in zip(members, want, physical):
        got = got.numpy()
        scale = np.abs(np.asarray(w) - np.asarray(xn)).max()
        assert np.abs(got - np.asarray(w)).max() <= TOL * np.abs(np.asarray(w)).max()
        phys = np.asarray(jnorm.normalize_input(p))  # where credit_tpu's member starts
        assert np.abs(phys - np.asarray(w)).max() > 0.1 * scale


# --------------------------------------------------------------- rollout_metrics
class _DenormalizeOnly:
    """A Normalizer that leaves inputs and forcing as they are and
    denormalizes predictions."""

    def __init__(self, norm):
        self.norm = norm

    def normalize_input(self, x):
        return x

    def normalize_forcing(self, f, schema):
        return f

    def denormalize_target(self, y):
        return self.norm.denormalize_target(y)


@pytest.fixture
def normalize_once(monkeypatch):
    """credit_tpu's RolloutEngine.run without normalizing the x0 and the
    forcing that rollout_metrics already normalized."""
    run = jrollout.RolloutEngine.run

    def once(self, *args, **kwargs):
        norm = self.normalizer
        self.normalizer = _DenormalizeOnly(norm)
        try:
            return run(self, *args, **kwargs)
        finally:
            self.normalizer = norm

    monkeypatch.setattr(jrollout.RolloutEngine, "run", once)


@pytest.fixture
def no_bias_fill(monkeypatch):
    """credit_tpu's RolloutEngine without its first-step position-bias
    fill: its bred members step the engine inside a traced loop, where the
    fill stores a traced table into the engine (a leak of its own, at any
    member count). The tables are the same without the fill."""
    init = jrollout.RolloutEngine.__init__

    def no_fill(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._dpb_pending = False

    monkeypatch.setattr(jrollout.RolloutEngine, "__init__", no_fill)


def _metrics_conf(env, tmp_path, name, **ensemble):
    conf = _rollout_conf(env, tmp_path / name, tmp_path / f"{name}_out")
    conf["seed"] = 3
    conf["predict"] = {"forecast_steps": 2, "ensemble": {"amplitude": 0.05, **ensemble}}
    return conf


def _metrics_draws(perturbation, n, shape, lmax=None, mmax=None):
    key = jax.random.PRNGKey(3)
    if perturbation == "bred":
        out, k = [], key
        for _ in range((n + 1) // 2):
            k, sub = jax.random.split(k)
            out.append(jax.random.normal(sub, shape))
        return out
    keys = jax.random.split(key, n)
    if perturbation == "spherical":
        spec = (*shape[:2], shape[-1], lmax, mmax)
        return [d for k in keys for d in (jax.random.normal(s, spec)
                                          for s in jax.random.split(k))]
    return [jax.random.normal(k, shape) for k in keys]


def _rows_close(got, want):
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k in w:
            _metric_close(k, g[k], w[k])


@pytest.mark.parametrize("perturbation,n", [("gaussian", 3), ("spherical", 2), ("bred", 2)])
def test_rollout_metrics_match_reference(env, tmp_path, jweights, replay, normalize_once,
                                         no_bias_fill, perturbation, n):
    """Rows of 2 leads (crps, crps_<var>, rmse, acc, spread,
    spread_skill_ratio) with credit_tpu's draws replayed, credit_tpu's
    harness normalizing once (`normalize_once`); bred at 2 members, which
    credit_tpu runs without its position-bias fill."""
    conf = _metrics_conf(env, tmp_path, "port", perturbation=perturbation, size=n)
    want = jmetrics.run_rollout_metrics(_metrics_conf(env, tmp_path, "jax", perturbation=
                                                      perturbation, size=n))
    _save_port_checkpoint(conf, env["variables"])
    exp = experiment.build_data(conf)
    shape = (1, 1, H, W, exp["schema"].n_input)
    queue = replay(_metrics_draws(perturbation, n, shape, H, min(H, W // 2 + 1)))
    got = run_rollout_metrics(conf, device="cpu")
    assert not queue and len(got) == 2 and got[1]["lead_hours"] == 12
    _rows_close(got, want)
    assert all(r["spread"] > 0 for r in got)


def test_rollout_metrics_faults_of_the_reference(env, tmp_path, jweights, replay,
                                                no_bias_fill):
    """credit_tpu's bred members raise at 3 members (its engine's key leaks
    out of the traced breeding loop into the second pair's) where the port
    runs; unpatched,
    credit_tpu normalizes the IC and the forcing twice and its rows land
    far from the port's, which normalize once (the parity test above)."""
    with pytest.raises(jax.errors.UnexpectedTracerError):
        jmetrics.run_rollout_metrics(_metrics_conf(env, tmp_path, "jax3", perturbation="bred",
                                                   size=3))
    conf = _metrics_conf(env, tmp_path, "port", perturbation="gaussian", size=2)
    _save_port_checkpoint(conf, env["variables"])
    shape = (1, 1, H, W, experiment.build_data(conf)["schema"].n_input)
    twice = jmetrics.run_rollout_metrics(_metrics_conf(env, tmp_path, "jax", size=2))
    replay(_metrics_draws("gaussian", 2, shape) + _metrics_draws("bred", 3, shape))
    once = run_rollout_metrics(conf, device="cpu")
    assert abs(once[0]["rmse"] - twice[0]["rmse"]) > 0.1 * abs(once[0]["rmse"])
    rows = run_rollout_metrics({**conf, "predict": {**conf["predict"], "ensemble": {
        "amplitude": 0.05, "perturbation": "bred", "size": 3}}}, device="cpu")
    assert len(rows) == 2 and all(np.isfinite(r["crps"]) and r["spread"] > 0 for r in rows)


@pytest.mark.parametrize("model_type", ["crossformer", "crossformer-ensemble"])
def test_rollout_metrics_model_perturbation(env, tmp_path, model_type):
    """perturbation: model starts every member from the same IC: spread
    from the model's own noise (each member's engine reseeded), 0 for a
    deterministic model, as credit_tpu's harness gives."""
    conf = _metrics_conf(env, tmp_path, "m", perturbation="model", size=2)
    conf["model"]["type"] = model_type
    rows = run_rollout_metrics(conf, n_steps=1, device="cpu")
    assert np.isfinite(rows[0]["crps"])
    assert (rows[0]["spread"] > 0) == (model_type == "crossformer-ensemble")


# --------------------------------------------------------------- ensemble_eval
EVAL_CONF = {
    "model": {"type": "crossformer", "frames": 1, "image_height": 16, "image_width": 32,
              "levels": 2, "channels": 3, "surface_channels": 2, "input_only_channels": 0,
              "output_only_channels": 0},
    "data": {"source": {"ERA5": {
        "levels": [500.0, 850.0],
        "variables": {"prognostic": {"vars_3D": ["U", "V", "T"], "vars_2D": ["U10", "V10"]}}}},
        "n_times": 6},
}


def test_ensemble_eval_matches_reference(tmp_path):
    """A saved tree (written by the port's writer): init0001 with two
    members over two leads, init0004 with one member whose lead 12 is
    missing (its valid time past the clock for lead 12 anyway), init0002
    alone. Both packages' evaluate_tree rows on the same dataset within
    1e-5: spread, rmse, spread-skill, the latitude bands, binned
    spread-skill, zonal error power, and the rotational and divergent KE
    band sums of each U/V pair; run_ensemble_eval writes them as JSON."""
    exp = experiment.build_data(EVAL_CONF)
    schema = exp["schema"]
    grid = Grid.regular(16, 32, levels=[500.0, 850.0])
    rng = np.random.default_rng(0)
    for label, leads in [("init0001", (6, 12)), ("init0001_e01", (6, 12)),
                         ("init0001_e02", (6, 12)), ("init0004", (6, 12)),
                         ("init0004_e01", (6,)), ("init0002", (6,))]:
        for fhr in leads:
            y = rng.normal(0, 5, (1, 16, 32, schema.n_target)).astype(np.float32)
            save_netcdf_increment(y, schema, grid, str(tmp_path / "tree"), label, fhr)
    assert ensemble_eval.discover_groups(str(tmp_path / "tree")) == jeval.discover_groups(
        str(tmp_path / "tree"))
    want = jeval.evaluate_tree(EVAL_CONF, str(tmp_path / "tree"), n_bins=4,
                               dataset=exp["dataset"])
    got = ensemble_eval.run_ensemble_eval(EVAL_CONF, str(tmp_path / "tree"), n_bins=4,
                                          out_path=str(tmp_path / "rows.json"), device="cpu")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert {"ke_rot_U_L0", "ke_div_U10", "rmse", "std_tropics", "bin_rmse"} <= set(got[0])
    assert [r["n_members"] for r in got] == [3, 3, 1, 2]
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, list):
                np.testing.assert_allclose(g[k], v, rtol=TOL, atol=0)
            elif isinstance(v, str) or k in ("lead_hours", "n_members"):
                assert g[k] == v
            else:
                _metric_close(k, g[k], v)
    with open(tmp_path / "rows.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))

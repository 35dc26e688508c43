"""The port's `credit-torch` CLI (cli/main.py) on tests/test_cli.py's cases,
held against credit-tpu's where both compute the same thing (summary,
metrics, preprocess, solar), its convert-checkpoint into the port's own
checkpoint, and the jax-free helpers around it: ocean.py, tuning.py (a
stub trial), visualization.py and manifests.py, against tests/test_aux.py,
tests/test_tuning.py, tests/test_visualization.py and
tests/test_hf_manifests.py.
"""

import contextlib
import copy
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from credit_tpu import ocean as jocean
from credit_tpu import visualization as jviz
from credit_tpu.utils.ncio import open_dataset as jopen_dataset
from credit_torch import ocean, visualization as viz
from credit_torch.cli.main import build_parser, main, parameter_rows
from credit_torch.convert_jax import expected_state
from credit_torch.utils.ncio import open_dataset
from tests.test_rollout_multi_init import CONF as TUNE_CONF
from tests.test_torch_port_model import CONFS, DATA
from tests.test_tuning import StubTrial
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

# credit_tpu.cli's package namespace holds the function `main`, not the module
jcli = importlib.import_module("credit_tpu.cli.main")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBCOMMANDS = ["init", "train", "rollout", "realtime", "preprocess", "convert", "metrics",
               "plot", "submit", "ensemble-eval", "rollout-metrics", "summary", "tune",
               "convert-checkpoint", "benchmark", "solar", "serve"]


def _write_tiny_conf(tmp_path, name="conf.yml", **extra):
    conf = {
        "save_loc": str(tmp_path / "exp"),
        "data": {"source": {"E": {"levels": [0.0], "variables": {
            "prognostic": {"vars_2D": ["T", "SP"]}}}},
            "history_len": 1, "forecast_len": 1, "n_times": 12},
        "trainer": {"learning_rate": 1e-3, "train_batch_size": 2,
                    "batches_per_epoch": 2, "num_epoch": 1, "preflight": False},
        "model": {"type": "debugger", "image_height": 8, "image_width": 16,
                  "levels": 1, "channels": 0, "surface_channels": 2,
                  "input_only_channels": 0, "output_only_channels": 0},
        "loss": {"training_loss": "mse"},
        "predict": {"forecast_steps": 2},
        **extra,
    }
    p = tmp_path / name
    yaml.safe_dump(conf, open(p, "w"))
    return str(p)


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_parser_has_all_subcommands():
    ours = next(a for a in build_parser()._actions if a.dest == "cmd").choices
    theirs = next(a for a in jcli.build_parser()._actions if a.dest == "cmd").choices
    assert sorted(ours) == sorted(theirs) == sorted(SUBCOMMANDS)
    # every argument credit-tpu takes, but its TPU-VM launcher's (submit
    # --scheduler gcloud, which the port refuses): those the port refuses too
    gcloud_only = {"submit": {"tpu_name", "zone"}}
    for cmd in SUBCOMMANDS:
        want = {a.dest for a in theirs[cmd]._actions}
        have = {a.dest for a in ours[cmd]._actions}
        assert want - gcloud_only.get(cmd, set()) <= have, cmd
        assert not gcloud_only.get(cmd, set()) & have, cmd


def test_tune_without_optuna_fails_cleanly(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    conf = _write_tiny_conf(tmp_path)
    import builtins

    real_import = builtins.__import__

    def fake(name, *a, **k):
        if name == "optuna":
            raise ImportError("no optuna")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", fake)
    assert main(["tune", conf, "--trials", "1", "--device", "cpu"]) == 2


def test_init_writes_template(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(["init", "t.yml"]) == 0
    conf = yaml.safe_load(open("t.yml"))
    assert conf["model"]["type"] == "crossformer"
    assert conf == yaml.safe_load(jcli.TEMPLATE)
    assert main(["init", "t.yml"]) == 1
    assert main(["init", "t.yml", "--force"]) == 0


def test_submit_generates_scripts(tmp_path, monkeypatch):
    """SLURM and PBS scripts start `python -m credit_torch.cli train` with
    the CREDIT_* variables, one process a GPU; gcloud (TPU VMs) and a
    --tpu-name exit 2."""
    monkeypatch.chdir(tmp_path)
    conf = _write_tiny_conf(tmp_path)
    for sched, needle in (("slurm", "#SBATCH"), ("pbs", "#PBS")):
        assert main(["submit", conf, "--scheduler", sched, "--nodes", "2",
                     "--gpus-per-node", "4", "--out", f"l_{sched}.sh"]) == 0
        text = open(f"l_{sched}.sh").read()
        assert needle in text and "python -m credit_torch.cli train" in text, (sched, text)
        for var in ("CREDIT_COORDINATOR", "CREDIT_NUM_PROCESSES", "CREDIT_PROCESS_ID",
                    "LOCAL_RANK"):
            assert var in text, (sched, var)
        assert os.access(f"l_{sched}.sh", os.X_OK)
        subprocess.run(["bash", "-n", f"l_{sched}.sh"], check=True)
    assert "--ntasks-per-node=4" in open("l_slurm.sh").read()
    assert main(["submit", conf, "--scheduler", "gcloud", "--out", "g.sh"]) == 2
    assert not os.path.exists("g.sh")
    # credit-tpu's TPU-VM options are not the port's: argparse refuses them
    with pytest.raises(SystemExit) as e:
        main(["submit", conf, "--scheduler", "slurm", "--tpu-name", "t", "--out", "t.sh"])
    assert e.value.code == 2 and not os.path.exists("t.sh")


def test_submit_resubmit_chain(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    conf = _write_tiny_conf(tmp_path)
    assert main(["submit", conf, "--scheduler", "pbs", "--out", "j.sh",
                 "--resubmit", "3"]) == 0
    chain = open("j_chain.sh").read()
    assert "depend=afterok:$PREV" in chain and "seq 3" in chain
    assert os.access("j_chain.sh", os.X_OK)
    assert main(["submit", conf, "--scheduler", "slurm", "--out", "s.sh",
                 "--resubmit", "2"]) == 0
    chain = open("s_chain.sh").read()
    assert "--dependency=afterok:$PREV" in chain and "--parsable" in chain


def test_convert_legacy_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    legacy = {"data": {"variables": ["U"], "surface_variables": ["SP"],
                       "levels": [0, 1]},
              "model": {"type": "crossformer", "levels": 2}}
    yaml.safe_dump(legacy, open("old.yml", "w"))
    assert main(["convert", "old.yml", "--out", "new.yml"]) == 0
    assert jcli.main(["convert", "old.yml", "--out", "jnew.yml"]) == 0
    conv = yaml.safe_load(open("new.yml"))
    assert "source" in conv["data"] and conv == yaml.safe_load(open("jnew.yml"))


def test_train_rollout_metrics_summary_roundtrip(tmp_path, monkeypatch):
    """summary, train, rollout, metrics and preprocess on the CPU; metrics
    and preprocess give credit-tpu's numbers on the same files and data."""
    monkeypatch.chdir(tmp_path)
    conf = _write_tiny_conf(tmp_path)
    assert main(["summary", conf]) == 0
    assert main(["train", conf, "--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / "exp" / "training_log.csv")
    assert main(["rollout", conf, "--steps", "2", "--device", "cpu"]) == 0
    fdir = tmp_path / "exp" / "forecasts" / "init0001"
    files = [str(fdir / f) for f in sorted(os.listdir(fdir))]
    assert len(files) == 2
    rc, out = _stdout(main, ["metrics", conf, *files])
    jrc, jout = _stdout(jcli.main, ["metrics", conf, *files])
    assert rc == jrc == 0
    rows, jrows = json.loads(out), json.loads(jout)
    assert [r["file"] for r in rows] == [r["file"] for r in jrows]
    for r, j in zip(rows, jrows):
        for k in ("rmse", "mae", "acc"):
            assert abs(r[k] - j[k]) <= 1e-5 * max(abs(j[k]), 1.0), (k, r, j)
    assert main(["preprocess", conf, "--samples", "4", "--scaler", "quantile"]) == 0
    ours = dict(np.load(tmp_path / "exp" / "normalization.npz"))
    scaler = dict(np.load(tmp_path / "exp" / "scaler.npz"))
    assert jcli.main(["preprocess", conf, "--samples", "4", "--scaler", "quantile"]) == 0
    for name, got in ((tmp_path / "exp" / "normalization.npz", ours),
                      (tmp_path / "exp" / "scaler.npz", scaler)):
        want = dict(np.load(name))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert main(["rollout", conf, "--steps", "1", "--device", "cpu", "--out",
                 str(tmp_path / "again"), "--diff-against", str(tmp_path / "exp" / "forecasts")
                 ]) == 0


def test_summary_counts_match_reference(tmp_path):
    """Per-block and total parameter counts, verbose rows included: the
    same lines credit-tpu prints from jax.eval_shape (a tiny CrossFormer and
    a tiny FuXi), the model built on the meta device."""
    from tests.test_fuxi_swin import FUXI_CONF

    for name, model, frames in (("cf", CONFS["quadrant"]["model"], 1),
                                ("fx", FUXI_CONF["model"], 2)):
        p = tmp_path / f"{name}.yml"
        yaml.safe_dump({"model": model, "data": {**DATA, "history_len": frames}}, open(p, "w"))
        rc, out = _stdout(main, ["summary", str(p), "-v"])
        jrc, jout = _stdout(jcli.main, ["summary", str(p), "-v"])
        assert rc == jrc == 0
        assert sorted(out.splitlines()) == sorted(jout.splitlines())
    rows = parameter_rows({"model": model})
    assert all(isinstance(n, int) for _, _, n in rows)


def test_preprocess_accepts_data_only_config(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    conf = {
        "save_loc": str(tmp_path / "exp"),
        "data": {"source": {"E": {"resolution": "16x8", "levels": [0.0],
                                  "variables": {"prognostic": {
                                      "vars_2D": ["T", "SP"]}}}},
                 "history_len": 1, "forecast_len": 1, "n_times": 12},
    }
    p = tmp_path / "donly.json"  # JSON is YAML: load_config reads it as such
    json.dump(conf, open(p, "w"))
    assert main(["preprocess", str(p), "--samples", "4"]) == 0
    assert os.path.exists(tmp_path / "exp" / "normalization.npz")
    from credit_torch.config import load_config

    with pytest.raises(ValueError):
        load_config(str(p))


def test_cli_solar_precompute(tmp_path):
    """Rank-strided TSI files, bitwise credit-tpu's."""
    args = ["solar", "--start", "2000-06-01", "--end", "2000-06-01 18:00", "--step", "6h",
            "--nlat", "19", "--nlon", "36", "--world", "2", "--rank", "1"]
    assert main(args + ["--out", str(tmp_path / "solar")]) == 0
    assert jcli.main(args + ["--out", str(tmp_path / "jsolar")]) == 0
    files = sorted((tmp_path / "solar").iterdir())
    assert [f.name for f in files] == sorted(f.name for f in (tmp_path / "jsolar").iterdir())
    assert len(files) == 2
    for f in files:
        ds, jds = open_dataset(str(f)), jopen_dataset(str(tmp_path / "jsolar" / f.name))
        tsi = np.asarray(ds["tsi"].values)
        np.testing.assert_array_equal(tsi, np.asarray(jds["tsi"].values))
        assert tsi.shape == (1, 19, 36) and np.all(tsi >= 0) and tsi.max() > 1e5
        assert ds["tsi"].attrs.get("units") == "J m**-2"


def test_plot_png_and_animation(tmp_path):
    pytest.importorskip("matplotlib")
    from credit_torch.output import save_netcdf_increment
    from credit_torch.data.channels import ChannelSchema
    from credit_torch.grid import Grid

    conf = {"data": {"source": {"E": {"levels": [0.0, 1.0], "variables": {
        "prognostic": {"vars_3D": ["T"], "vars_2D": ["SP"]}}}}}}
    schema = ChannelSchema.from_config(conf)
    rng = np.random.default_rng(0)
    paths = [save_netcdf_increment(rng.standard_normal((1, 6, 12, schema.n_target)).astype(
        np.float32) + 280, schema, Grid.regular(6, 12, levels=[0.0, 1.0]), str(tmp_path),
        "init", 6 * (i + 1)) for i in range(2)]
    assert main(["plot", paths[0], "--out", str(tmp_path / "a.png")]) == 0
    assert main(["plot", *paths, "--var", "T", "--out", str(tmp_path / "a.gif")]) == 0
    assert (tmp_path / "a.png").stat().st_size > 0 and (tmp_path / "a.gif").stat().st_size > 0


# --------------------------------------------------------------- convert-checkpoint
def test_convert_checkpoint_tiny_then_rollout_and_resume(tmp_path, monkeypatch):
    """A CREDIT .pt (model_state_dict container) of a tiny CrossFormer
    through convert-checkpoint: state.pt holds every tensor of the port's
    training model and step 0, no optimizer state; rollout reads it (without
    the optimizer state) and gives the forward of the converted weights;
    a fit resumed from it (load_weights) starts at epoch 0 with a fresh
    optimizer."""
    from credit_tpu.models import load_model as jax_load_model
    from credit_torch.applications import prepare_training
    from credit_torch.convert_torch import convert_crossformer
    from tests.test_torch_port_convert import credit_state_dict
    from tests.test_torch_port_model import _numpy_variables, _to_numpy

    monkeypatch.chdir(tmp_path)
    conf = {**copy.deepcopy(CONFS["padded"]), "data": {**DATA, "n_times": 12},
            "save_loc": str(tmp_path / "exp"),
            "trainer": {"learning_rate": 1e-3, "train_batch_size": 1, "batches_per_epoch": 1,
                        "num_epoch": 1, "preflight": False, "load_weights": True},
            "loss": {"training_loss": "mse"}}
    p = tmp_path / "c.yml"
    yaml.safe_dump(conf, open(p, "w"))
    jmodel = jax_load_model(conf)
    x = np.zeros((1, 1, 32, 64, jmodel.base_input_channels), np.float32)
    sd = credit_state_dict(_to_numpy(_numpy_variables(jmodel, x, 8)))
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()}},
               tmp_path / "credit.pt")
    rc, out = _stdout(main, ["convert-checkpoint", str(p), str(tmp_path / "credit.pt"),
                             "--device", "cpu"])
    assert rc == 0 and out.strip() == str(tmp_path / "exp" / "checkpoint")
    saved = torch.load(tmp_path / "exp" / "checkpoint" / "state.pt", weights_only=True)
    assert sorted(saved) == ["model", "step"] and saved["step"] == 0
    assert set(saved["model"]) == set(expected_state(conf, sn_state=True))
    want = convert_crossformer(sd, conf)
    assert all(torch.equal(saved["model"][k], v) for k, v in want.items())
    assert main(["rollout", str(p), "--steps", "1", "--device", "cpu"]) == 0
    trainer, state, start_epoch, _ = prepare_training(conf, device="cpu")
    assert start_epoch == 0 and state.step == 0
    assert torch.equal(trainer.model.state_dict()["cel0.conv0.kernel"],
                       want["cel0.conv0.kernel"])


def test_convert_checkpoint_dry_run_manifest(tmp_path):
    """--dry-run-manifest wxformer_6h: the published layout converted at
    full width into state.pt, strict into the port's model on the CPU."""
    p = _write_tiny_conf(tmp_path)
    rc, out = _stdout(main, ["convert-checkpoint", p, "--dry-run-manifest", "wxformer_6h",
                             "--out", str(tmp_path / "wx"), "--device", "cpu"])
    assert rc == 0 and out.strip() == str(tmp_path / "wx")
    saved = torch.load(tmp_path / "wx" / "state.pt", weights_only=True)
    from credit_torch.manifests import MANIFEST_MODEL_CONF

    want = expected_state({"model": MANIFEST_MODEL_CONF["wxformer_6h"]}, sn_state=True)
    assert {k: v.shape for k, v in saved["model"].items()} == want
    n = sum(v.numel() for k, v in saved["model"].items() if not k.endswith((".u", ".v")))
    assert abs(n / 1e6 - 124.39) < 0.01


def test_python_dash_m_entry_points(tmp_path):
    """`python -m credit_torch` and `python -m credit_torch.cli` run the CLI
    without importing jax."""
    code = ("import runpy, sys\n"
            "sys.argv = ['credit-torch', 'init', sys.argv[1]]\n"
            "try:\n    runpy.run_module('credit_torch', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n"
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "a.yml")], cwd=ROOT, check=True)
    out = subprocess.run([sys.executable, "-m", "credit_torch.cli", "submit", "x.yml",
                          "--scheduler", "gcloud"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 2 and "gcloud" in out.stderr
    assert (tmp_path / "a.yml").exists()


# --------------------------------------------------------------- helpers
def test_samudra_ocean_utils():
    """test_aux.py's Samudra case on the port, and its tables equal credit_tpu's."""
    assert ocean.DEPTH_I_LEVELS == jocean.DEPTH_I_LEVELS and len(ocean.DEPTH_I_LEVELS) == 19
    assert ocean.MASK_VARS == jocean.MASK_VARS
    assert ocean.PROG_VARS_MAP == jocean.PROG_VARS_MAP
    assert ocean.BOUND_VARS_MAP == jocean.BOUND_VARS_MAP
    assert len(ocean.PROG_VARS_MAP["thermo"]) == 2 * 19 + 1
    assert ocean.depth_index("thetao_2_5") == 0
    assert ocean.depth_index("so_6000_0") == 18
    assert ocean.depth_index("zos") == 0
    rng = np.random.default_rng(0)
    masks = {m: (rng.uniform(0, 1, (4, 8)) > 0.3).astype(np.float32) for m in ocean.MASK_VARS}
    outputs = ["thetao_2_5", "thetao_6000_0", "zos"]
    wet, surf = ocean.extract_wet_mask(masks, outputs, hist=1)
    jwet, jsurf = jocean.extract_wet_mask(masks, outputs, hist=1)
    assert wet.shape == (4, 8, 6)
    np.testing.assert_array_equal(wet, jwet)
    np.testing.assert_array_equal(surf, jsurf)
    np.testing.assert_array_equal(wet[..., 1], masks[ocean.MASK_VARS[18]])
    assert ocean.get_inference_steps("2000-01-01", "2000-03-01", 5, 1) == 12
    for args in (("2001-01-01", "2001-12-31", 3, 2), ("2000-02-01", "2000-03-01", 1, 0)):
        assert ocean.get_inference_steps(*args) == jocean.get_inference_steps(*args)


def test_tuning_set_by_path_and_suggest():
    from credit_torch.tuning import set_by_path, suggest_overrides

    conf = {}
    set_by_path(conf, "trainer.learning_rate", 1e-4)
    assert conf == {"trainer": {"learning_rate": 1e-4}}
    t = StubTrial()
    out = suggest_overrides(t, {
        "trainer.learning_rate": {"type": "float", "low": 1e-5, "high": 1e-3, "log": True},
        "model.dim_head": {"type": "categorical", "choices": [16, 32]},
        "trainer.num_epoch": {"type": "int", "low": 1, "high": 3},
    })
    assert 1e-5 < out["trainer.learning_rate"] < 1e-3
    assert out["model.dim_head"] == 16 and out["trainer.num_epoch"] == 2
    with pytest.raises(ValueError, match="unknown hyperparameter type"):
        suggest_overrides(t, {"a": {"type": "complex"}})


def test_tuning_objective_runs_trial_and_reports(tmp_path):
    from credit_torch.tuning import Objective

    conf = copy.deepcopy(TUNE_CONF)
    conf["save_loc"] = str(tmp_path)
    conf["trainer"].update({"num_epoch": 2, "batches_per_epoch": 2,
                            "valid_batches_per_epoch": 1, "use_ema": False})
    obj = Objective(conf, metric="train_loss", device="cpu", space={
        "trainer.learning_rate": {"type": "float", "low": 1e-4, "high": 1e-2, "log": True}})
    t = StubTrial()
    val = obj(t)
    assert np.isfinite(val) and val > 0
    assert "trainer.learning_rate" in t.suggested
    assert len(t.reports) == 2
    assert os.path.exists(tmp_path / "trial_0000" / "training_log.csv")


def test_tuning_prunes_out_of_memory(tmp_path, monkeypatch):
    """A trial that runs out of device memory is pruned (optuna.TrialPruned);
    optuna is absent here, so the prune raises the ImportError naming it."""
    from credit_torch import tuning
    from credit_torch.trainers import trainer as ttrainer

    def oom(self, *a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")

    monkeypatch.setattr(ttrainer.Trainer, "fit", oom)
    conf = {**copy.deepcopy(TUNE_CONF), "save_loc": str(tmp_path)}
    try:
        import optuna  # noqa: F401
        expected = optuna.TrialPruned
    except ImportError:
        expected = ImportError
    with pytest.raises(expected, match="optuna" if expected is ImportError else ""):
        tuning.Objective(conf, device="cpu")(StubTrial())
    assert tuning._out_of_memory(RuntimeError("CUDA error: out of memory"))
    assert not tuning._out_of_memory(RuntimeError("shape mismatch"))


def test_visualization_matches_reference():
    """test_visualization.py's cases on the port, each equal to credit_tpu's."""
    assert viz.kgkg_to_gkg(0.012) == 12.0 and viz.k_to_c(273.15) == 0.0
    assert viz.k_to_f(273.15) == 32.0
    np.testing.assert_allclose(viz.pa_to_hpa(101325.0), 1013.25)
    np.testing.assert_allclose(viz.gp_to_height_dam(9.80665 * 5500.0), 550.0)
    arr = np.array([300.0])
    for name in ("T_L5", "SP", "VAR_2T", "Z_L0", "Q", "unknown_var"):
        out, units = viz.convert_for_display(name, arr)
        jout, junits = jviz.convert_for_display(name, arr)
        np.testing.assert_array_equal(out, jout)
        assert units == junits
    assert viz.convert_for_display("VAR_2T", arr)[1] == "degC"
    x = np.random.default_rng(0).normal(10.0, 2.0, 10000)
    for method in ("mean_std", "minmax"):
        assert viz.variable_range(x, method) == jviz.variable_range(x, method)
    lo, hi = viz.round_range(0.123, 9.87)
    assert (lo, hi) == jviz.round_range(0.123, 9.87) and lo <= 0.123 and hi >= 9.87
    for rngs in [((0, 1), (0, 1)), ((-1, 1), (0, 1)), ((0, 2), (0, 1)), ((-1, 2), (0, 1))]:
        assert viz.colormap_extend(*rngs) == jviz.colormap_extend(*rngs)
    for n in (1, 2, 4, 6, 11):
        assert viz.panel_grid(n) == jviz.panel_grid(n)
    for name in ("U_L3", "Q_L0", "T_L5", "SP", "TP"):
        assert viz.pick_colormap(name) == jviz.pick_colormap(name)


def test_draw_field_matches_reference():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    field = np.random.default_rng(1).normal(280, 5, (6, 12))
    fig, (a, b) = plt.subplots(1, 2)
    im = viz.draw_field(a, field, "T_L2", np.linspace(90, -90, 6), np.arange(12) * 30.0)
    jim = jviz.draw_field(b, field, "T_L2", np.linspace(90, -90, 6), np.arange(12) * 30.0)
    np.testing.assert_array_equal(im.get_array(), jim.get_array())
    assert im.get_clim() == jim.get_clim() and a.get_title() == b.get_title() == "T_L2 [degC]"
    plt.close(fig)

"""The port's `Trainer.fit` on the card against the same fit on the CPU.

The tiny CrossFormer in f32 (TF32 off) trains two epochs on a seeded zarr
store through `run_training`: on the card the batches are pinned, copied
asynchronously and validated on the EMA weights there. Every cell of
training_log.csv but `seconds` agrees with the CPU run within 1e-4
(relative). This file imports no credit_tpu (the card's machine has no
flax): `python -m pytest tests/test_torch_port_fit_card.py -m cuda`.
"""

import csv
import os

import pytest
import torch

from credit_torch.applications import run_training
from credit_torch.data import zarrlite
from credit_torch.utils import ncio
from torch_port_fixtures import fit_conf, write_era5_store, write_stats


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def _log(save_loc):
    with open(os.path.join(save_loc, "training_log.csv")) as f:
        return list(csv.reader(f))


@pytest.mark.cuda
def test_tiny_fit_on_card_matches_cpu(cuda, tmp_path):
    store = write_era5_store(tmp_path / "era5.zarr", zarrlite.write_array)
    stats = write_stats(tmp_path, ncio)
    logs, states = {}, {}
    for dev in ("cpu", "cuda"):
        conf = fit_conf(store, stats, tmp_path / dev, replay={"capacity": 4, "probability": 0.5})
        states[dev] = run_training(conf, device=dev)
        logs[dev] = _log(conf["save_loc"])
    header = logs["cpu"][0]
    assert logs["cuda"][0] == header and len(logs["cuda"]) == 3
    for crow, grow in zip(logs["cpu"][1:], logs["cuda"][1:]):
        for name, a, b in zip(header, grow, crow):
            if name != "seconds":
                assert abs(float(a) - float(b)) <= 1e-4 * max(abs(float(b)), 1e-12), name
    model = states["cuda"].model
    assert next(model.parameters()).is_cuda and states["cuda"].step == states["cpu"].step == 4
    assert all(v.is_cuda for v in states["cuda"].ema_params.values())


@pytest.mark.cuda
def test_preflight_memory_probe_restores_the_state(cuda, tmp_path):
    """preflight 'full': one real step on the card for the allocator's peak,
    after which the parameters, u/v, moments and EMA are bitwise as before
    and a fit continues from them."""
    from credit_torch.applications import prepare_training
    from credit_torch.trainers.preflight import estimate_train_memory

    store = write_era5_store(tmp_path / "era5.zarr", zarrlite.write_array)
    conf = fit_conf(store, write_stats(tmp_path, ncio), tmp_path / "run")
    trainer, _, _, _ = prepare_training(conf, device="cuda")
    state = trainer.init_state()
    raw = trainer.dataset.batch([0, 1], 1)
    batch = trainer._to_device({k: trainer._host_tensor(k, v) for k, v in raw.items()})
    before = [t.clone() for t in (list(state.model.state_dict().values())
                                  + list(state.opt_state["mu"].values())
                                  + list(state.ema_params.values()))]
    out = estimate_train_memory(trainer._train_step_for(1), state, batch)
    assert out["peak_gb"] > out["state_gb"] > 0
    after = (list(state.model.state_dict().values()) + list(state.opt_state["mu"].values())
             + list(state.ema_params.values()))
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert state.step == 0 and state.opt_state["count"] == 0

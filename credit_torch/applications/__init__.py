"""Application glue: build and run training from a config (port of
credit_tpu/applications)."""

from credit_torch.applications.experiment import (  # noqa: F401
    build_experiment, prepare_training, run_rollout, run_training)

"""Application glue: build and run training and rollouts from a config (port
of credit_tpu/applications)."""

from credit_torch.applications.experiment import (  # noqa: F401
    build_experiment, diff_rollout, prepare_training, run_rollout, run_training)

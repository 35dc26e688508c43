"""Training (port of credit_tpu/trainers): the train and eval steps, the
optimizer and `Trainer.fit` (`trainer.py`), the diffusion trainer
(`diffusion.py`), initial-condition optimization (`ic_optimization.py`,
`ic-opt`), the preflight checks (`preflight.py`) and the learning-rate
schedules (`scheduler.py`)."""

"""Training (port of credit_tpu/trainers): the train and eval steps, the
optimizer and `Trainer.fit` (`trainer.py`), the preflight checks
(`preflight.py`) and the learning-rate schedules (`scheduler.py`)."""

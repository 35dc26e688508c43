"""Training (port of credit_tpu/trainers): the train step and its optimizer
(`trainer.py`) and the learning-rate schedules (`scheduler.py`)."""

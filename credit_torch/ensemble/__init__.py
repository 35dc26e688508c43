"""Ensemble generation: IC/model noise, bred vectors, the SDL wrapper
(port of credit_tpu/ensemble)."""

from credit_torch.ensemble.noise import (  # noqa: F401
    ColorNoise, GaussianNoise, SphericalNoise, TemporalNoise)
from credit_torch.ensemble.bred_vector import generate_bred_vectors  # noqa: F401

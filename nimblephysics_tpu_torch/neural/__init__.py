"""Differentiability layer: the differentiable timestep of one world."""

from nimblephysics_tpu_torch.neural.timestep import (
    Engine,
    StepResult,
    get_engine,
    timestep,
)

"""Policy-gradient training through the batched engine (one device)."""

from nimblephysics_tpu_torch.parallel.mesh import (
    MlpPolicy,
    TrainStepResult,
    train_step_batched,
)

"""Trajectory optimization (reference: dart/trajectory, SURVEY.md 2.5)."""

from nimblephysics_tpu_torch.trajectory.problem import (
    LossFn,
    MultiShot,
    Problem,
    SingleShot,
    TerminalResiduals,
    TrajectoryRollout,
)
from nimblephysics_tpu_torch.trajectory.optimizers import (
    AugmentedLagrangianOptimizer,
    GaussNewtonOptimizer,
    HostInteriorPointOptimizer,
    IPOptOptimizer,
    SGDOptimizer,
    Solution,
)

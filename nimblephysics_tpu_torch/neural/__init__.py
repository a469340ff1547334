"""Differentiability layer (reference: dart/neural, SURVEY.md 2.4).

The differentiable timestep, BackpropSnapshot Jacobian API, WithRespectTo
differentiation variables, and loss-space mappings.
"""

from nimblephysics_tpu_torch.neural.timestep import (
    Engine,
    StepResult,
    get_engine,
    timestep,
)
from nimblephysics_tpu_torch.neural.backprop_snapshot import (
    BackpropSnapshot,
    LossGradient,
    MappedBackpropSnapshot,
    forward_pass,
    mapped_forward_pass,
)
from nimblephysics_tpu_torch.neural.with_respect_to import (
    ACCELERATION,
    FORCE,
    GROUP_COMS,
    GROUP_INERTIAS,
    GROUP_MASSES,
    GROUP_SCALES,
    LINEARIZED_MASSES,
    POSITION,
    VELOCITY,
    WithRespectTo,
    jacobian_wrt,
)
from nimblephysics_tpu_torch.neural.mappings import (
    IKMapping,
    IdentityMapping,
    RestorableSnapshot,
    convert_joint_space_to_world_space,
    map_to_pos,
    map_to_vel,
)

# Reference-familiar aliases.
forwardPass = forward_pass

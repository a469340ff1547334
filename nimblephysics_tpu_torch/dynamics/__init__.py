"""Static skeleton, joint and shape specs (plan data)."""

from nimblephysics_tpu_torch.dynamics.joints import (
    PRISMATIC,
    REVOLUTE,
    WELD,
    JointSpec,
)
from nimblephysics_tpu_torch.dynamics.shapes import ShapeSpec
from nimblephysics_tpu_torch.dynamics.skeleton import BodySpec, Skeleton

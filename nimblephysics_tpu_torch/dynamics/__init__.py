"""Static skeleton, joint and shape specs (plan data)."""

from nimblephysics_tpu_torch.dynamics.joints import (
    BALL,
    EULER,
    EULER_FREE,
    FREE,
    PLANAR,
    PRISMATIC,
    REVOLUTE,
    SCREW,
    TRANSLATIONAL,
    TRANSLATIONAL_2D,
    UNIVERSAL,
    WELD,
    JointSpec,
)
from nimblephysics_tpu_torch.dynamics.shapes import ShapeSpec
from nimblephysics_tpu_torch.dynamics.skeleton import BodySpec, Skeleton

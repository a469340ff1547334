"""Static skeleton, joint and shape specs (plan data)."""

from nimblephysics_tpu_torch.dynamics.joints import (
    BALL,
    CONSTANT_CURVE,
    CONSTANT_CURVE_INCOMPRESSIBLE,
    CUSTOM,
    ELLIPSOID_JOINT,
    EULER,
    EULER_FREE,
    FREE,
    PLANAR,
    PRISMATIC,
    REVOLUTE,
    SCAPULATHORACIC,
    SCREW,
    TRANSLATIONAL,
    TRANSLATIONAL_2D,
    UNIVERSAL,
    WELD,
    CustomJointDef,
    JointSpec,
)
from nimblephysics_tpu_torch.dynamics.shapes import ShapeSpec
from nimblephysics_tpu_torch.dynamics.skeleton import BodySpec, Skeleton
from nimblephysics_tpu_torch.dynamics.simple_featherstone import (
    FlatChain,
    aba_forward_dynamics,
    flatten_chain,
)

"""Joint type tags, the static joint spec, and one joint's Q(q), S(q),
S-dot and position integration.

Counterpart of nimblephysics_tpu/dynamics/joints.py. Conventions match
the reference: T_rel(q) = T_pj @ Q(q) @ inv(T_cj), and the child body's
relative spatial velocity is Ad(T_cj) S(q) qdot. The kinematics of every
type live in batched/articulated.py (Q as rotation factors and
translation terms with S and its rate in closed form, or, for the
spline-driven and biomechanics joints, Q batched with S and its rate by
forward-mode differentiation); the functions here run them on a world of
one joint, with T_pj = T_cj = I, and a batch of one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

REVOLUTE = "revolute"
PRISMATIC = "prismatic"
SCREW = "screw"
UNIVERSAL = "universal"
BALL = "ball"
EULER = "euler"
TRANSLATIONAL = "translational"
TRANSLATIONAL_2D = "translational2d"
PLANAR = "planar"
FREE = "free"
EULER_FREE = "eulerfree"
WELD = "weld"
CUSTOM = "custom"
ELLIPSOID_JOINT = "ellipsoid"
SCAPULATHORACIC = "scapulathoracic"
CONSTANT_CURVE = "constantcurve"
CONSTANT_CURVE_INCOMPRESSIBLE = "constantcurveincompressible"

_NUM_DOFS = {
    REVOLUTE: 1,
    PRISMATIC: 1,
    SCREW: 1,
    UNIVERSAL: 2,
    BALL: 3,
    EULER: 3,
    TRANSLATIONAL: 3,
    TRANSLATIONAL_2D: 2,
    PLANAR: 3,
    FREE: 6,
    EULER_FREE: 6,
    WELD: 0,
    ELLIPSOID_JOINT: 3,
    SCAPULATHORACIC: 4,
    CONSTANT_CURVE: 4,
    CONSTANT_CURVE_INCOMPRESSIBLE: 3,
}


def num_dofs(joint_type: str) -> int:
    return _NUM_DOFS[joint_type]


@dataclasses.dataclass(frozen=True, eq=False)
class CustomJointDef:
    """A spline-driven custom joint (OpenSim CustomJoint): six transform
    axes, three rotations then three translations, each a 1-D function
    (math/splines.Fn) of one of the joint's coordinates or a constant:
      R = exp(rot_axes[0] f0) exp(rot_axes[1] f1) exp(rot_axes[2] f2),
      p = sum_i trans_axes[i] f_{3+i}."""

    n_dofs: int
    rot_axes: np.ndarray  # (3, 3) rows = axes
    trans_axes: np.ndarray  # (3, 3)
    functions: tuple  # 6 x math.splines.Fn
    drives: tuple  # 6 x int: the coordinate driving each axis (-1 = none)


@dataclasses.dataclass(frozen=True, eq=False)
class JointSpec:
    """Static description of one joint (reference Joint::Properties)."""

    joint_type: str
    name: str
    parent: int  # parent body index; -1 = world
    child: int
    q_index: int  # offset into the skeleton's q vector
    T_pj: np.ndarray  # (4, 4) transformFromParentBodyNode
    T_cj: np.ndarray  # (4, 4) transformFromChildBodyNode
    axes: Optional[np.ndarray] = None  # (ndof_axes, 3)
    euler_order: str = "xyz"  # euler and eulerfree: intrinsic axis order
    screw_pitch: float = 0.0  # screw: translation per radian along the axis
    damping: Optional[np.ndarray] = None
    spring_stiffness: Optional[np.ndarray] = None
    rest_position: Optional[np.ndarray] = None
    position_lower: Optional[np.ndarray] = None
    position_upper: Optional[np.ndarray] = None
    velocity_limit: Optional[np.ndarray] = None
    force_limit: Optional[np.ndarray] = None
    custom: Optional[CustomJointDef] = None  # for joint_type == CUSTOM
    # The biomechanics joints' static parameters:
    #   ellipsoid/scapulathoracic: radii (3,), euler_order, flip (3|4,),
    #     winging_axis_offset (2,), winging_axis_direction (scalar)
    #   constantcurve(incompressible): neutral (3|4,), flip (3,),
    #     length (incompressible only)
    props: Optional[dict] = None

    @property
    def num_dofs(self) -> int:
        if self.joint_type == CUSTOM:
            return self.custom.n_dofs
        return num_dofs(self.joint_type)

    def _coeff(self, field, default):
        v = getattr(self, field)
        if v is None:
            return np.full((self.num_dofs,), default, dtype=np.float64)
        return np.asarray(v, dtype=np.float64)

    def damping_vec(self):
        return self._coeff("damping", 0.0)

    def spring_vec(self):
        return self._coeff("spring_stiffness", 0.0)

    def rest_vec(self):
        return self._coeff("rest_position", 0.0)

    def pos_lower_vec(self):
        return self._coeff("position_lower", -np.inf)

    def pos_upper_vec(self):
        return self._coeff("position_upper", np.inf)

    def force_limit_vec(self):
        return self._coeff("force_limit", np.inf)

    def velocity_limit_vec(self):
        return self._coeff("velocity_limit", np.inf)


@functools.lru_cache(maxsize=256)
def _joint_world(spec: JointSpec):
    """The FlatWorld of a world holding this joint alone: its one body at
    the root, T_pj = T_cj = I, so that fk's S is the joint-frame S."""
    from nimblephysics_tpu_torch.batched.articulated import FlatWorld
    from nimblephysics_tpu_torch.dynamics.skeleton import BodySpec, Skeleton
    from nimblephysics_tpu_torch.simulation.world import World

    sk = Skeleton("joint")
    sk.joints.append(dataclasses.replace(spec, parent=-1, child=0, q_index=0,
                                         T_pj=np.eye(4), T_cj=np.eye(4)))
    sk.bodies.append(BodySpec("joint", 1.0, np.zeros(3), np.eye(3)))
    world = World()
    world.skeletons.append(sk)
    return FlatWorld(world)


def joint_transform(spec: JointSpec, q: torch.Tensor) -> torch.Tensor:
    """Q(q), the joint's configuration transform, 4x4."""
    from nimblephysics_tpu_torch.batched.articulated import _joint_Q
    from nimblephysics_tpu_torch.math.lie import rp_to_transform

    fw = _joint_world(spec)
    Rq, pq, _ = _joint_Q(fw.tensors(q.dtype, q.device), q[:, None])
    return rp_to_transform(Rq[0, :, :, 0], pq[0, :, 0])


def joint_body_jacobian(spec: JointSpec, q: torch.Tensor) -> torch.Tensor:
    """S(q) (6, ndof): qdot -> the joint-frame body twist of Q."""
    from nimblephysics_tpu_torch.batched.articulated import fk

    if spec.num_dofs == 0:
        return q.new_zeros(6, 0)
    S = fk(_joint_world(spec), q[:, None])[3][0]  # (6, nd, 1)
    return S[..., 0]


def joint_body_jacobian_dot(spec: JointSpec, q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """S-dot(q, qdot) = (dS/dq) qdot (6, ndof), by forward-mode
    differentiation of S. The step needs only S-dot qdot, which
    batched/articulated.py writes in closed form."""
    if spec.num_dofs == 0:
        return q.new_zeros(6, 0)
    return torch.func.jvp(lambda qq: joint_body_jacobian(spec, qq), (q,), (dq,))[1]


def integrate_positions(spec: JointSpec, q: torch.Tensor, dq: torch.Tensor, dt) -> torch.Tensor:
    """q_{t+1} from q_t, qdot and dt: q + qdot dt, and for ball and free
    joints the composition on the group, R' = exp(w) exp(J_r(w) dw dt)."""
    from nimblephysics_tpu_torch.batched.articulated import integrate_positions as ip

    return ip(_joint_world(spec), q[:, None], dq[:, None], dt)[:, 0]

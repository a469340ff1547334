"""Joint type tags and the static joint spec (plan fields only).

Counterpart of nimblephysics_tpu/dynamics/joints.py. Conventions match
the reference: T_rel(q) = T_pj @ Q(q) @ inv(T_cj), and the child body's
relative spatial velocity is Ad(T_cj) S(q) qdot. The batched kinematics
of the supported types live in batched/articulated.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

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
    if joint_type not in _NUM_DOFS:
        raise NotImplementedError(
            f"joint type {joint_type!r}: spline-driven custom joints come "
            "with the single-world reference path (ROADMAP queue 1 item 10)"
        )
    return _NUM_DOFS[joint_type]


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
    damping: Optional[np.ndarray] = None
    spring_stiffness: Optional[np.ndarray] = None
    rest_position: Optional[np.ndarray] = None
    position_lower: Optional[np.ndarray] = None
    position_upper: Optional[np.ndarray] = None
    velocity_limit: Optional[np.ndarray] = None
    force_limit: Optional[np.ndarray] = None

    @property
    def num_dofs(self) -> int:
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

"""Skeleton: static articulated-tree spec (builder and per-dof getters).

Counterpart of the plan half of nimblephysics_tpu/dynamics/skeleton.py.
One joint per body, parents precede children. The batched dynamics of a
skeleton live in batched/articulated.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from nimblephysics_tpu_torch.dynamics.joints import JointSpec
from nimblephysics_tpu_torch.dynamics.shapes import ShapeSpec


@dataclasses.dataclass(frozen=True, eq=False)
class BodySpec:
    """Static per-body data: inertia and attached shapes."""

    name: str
    mass: float
    com: np.ndarray  # (3,) in body frame
    inertia: np.ndarray  # (3, 3) about the COM, body frame
    shapes: Tuple[ShapeSpec, ...] = ()


def _unique_name(name: str, taken) -> str:
    """The reference NameManager rule: name, name(1), name(2), ..."""
    if name not in taken:
        return name
    k = 1
    while f"{name}({k})" in taken:
        k += 1
    return f"{name}({k})"


def _vec(x) -> Optional[np.ndarray]:
    return None if x is None else np.asarray(x, dtype=np.float64)


class Skeleton:
    """Static articulated tree (builder parity: add_joint_and_body)."""

    def __init__(self, name: str = "skeleton"):
        self.name = name
        self.joints: List[JointSpec] = []
        self.bodies: List[BodySpec] = []
        self.self_collision_enabled = False
        self.adjacent_body_check = False

    def set_self_collision_check(self, enabled: bool) -> None:
        self.self_collision_enabled = bool(enabled)

    def set_adjacent_body_check(self, enabled: bool) -> None:
        self.adjacent_body_check = bool(enabled)

    def add_joint_and_body(
        self,
        joint_type: str,
        parent: int = -1,
        name: Optional[str] = None,
        T_pj: Optional[np.ndarray] = None,
        T_cj: Optional[np.ndarray] = None,
        axis: Optional[Sequence] = None,
        axes: Optional[Sequence] = None,
        mass: float = 1.0,
        com: Sequence = (0.0, 0.0, 0.0),
        inertia: Optional[np.ndarray] = None,
        shapes: Sequence[ShapeSpec] = (),
        damping: Optional[Sequence] = None,
        spring_stiffness: Optional[Sequence] = None,
        rest_position: Optional[Sequence] = None,
        position_lower: Optional[Sequence] = None,
        position_upper: Optional[Sequence] = None,
        velocity_limit: Optional[Sequence] = None,
        force_limit: Optional[Sequence] = None,
    ) -> int:
        """Append a joint and its child body; returns the body index."""
        idx = len(self.bodies)
        if parent >= idx:
            raise ValueError("parents must be added before children")
        if axes is None and axis is not None:
            axes = [axis]
        body_name = _unique_name(
            name or f"body{idx}", {b.name for b in self.bodies}
        )
        spec = JointSpec(
            joint_type=joint_type,
            name=f"{body_name}_joint",
            parent=parent,
            child=idx,
            q_index=self.num_dofs,
            T_pj=np.eye(4) if T_pj is None else np.asarray(T_pj, np.float64),
            T_cj=np.eye(4) if T_cj is None else np.asarray(T_cj, np.float64),
            axes=(
                None
                if axes is None
                else np.asarray(axes, dtype=np.float64).reshape(-1, 3)
            ),
            damping=_vec(damping),
            spring_stiffness=_vec(spring_stiffness),
            rest_position=_vec(rest_position),
            position_lower=_vec(position_lower),
            position_upper=_vec(position_upper),
            velocity_limit=_vec(velocity_limit),
            force_limit=_vec(force_limit),
        )
        if inertia is None:
            inertia = np.eye(3) * 0.1 * mass
        self.joints.append(spec)
        self.bodies.append(
            BodySpec(
                name=body_name,
                mass=float(mass),
                com=np.asarray(com, dtype=np.float64),
                inertia=np.asarray(inertia, dtype=np.float64),
                shapes=tuple(shapes),
            )
        )
        return idx

    @property
    def num_bodies(self) -> int:
        return len(self.bodies)

    @property
    def num_dofs(self) -> int:
        return sum(j.num_dofs for j in self.joints)

    def _per_dof(self, getter) -> np.ndarray:
        if not self.joints:
            return np.zeros(0)
        return np.concatenate([getter(j) for j in self.joints])

    def damping_coeffs(self) -> np.ndarray:
        return self._per_dof(JointSpec.damping_vec)

    def spring_stiffnesses(self) -> np.ndarray:
        return self._per_dof(JointSpec.spring_vec)

    def rest_positions(self) -> np.ndarray:
        return self._per_dof(JointSpec.rest_vec)

    def position_lower_limits(self) -> np.ndarray:
        return self._per_dof(JointSpec.pos_lower_vec)

    def position_upper_limits(self) -> np.ndarray:
        return self._per_dof(JointSpec.pos_upper_vec)

    def force_limits(self) -> np.ndarray:
        return self._per_dof(JointSpec.force_limit_vec)

    def velocity_limits(self) -> np.ndarray:
        return self._per_dof(JointSpec.velocity_limit_vec)

    def __repr__(self):
        return (
            f"Skeleton({self.name!r}, bodies={self.num_bodies}, "
            f"dofs={self.num_dofs})"
        )

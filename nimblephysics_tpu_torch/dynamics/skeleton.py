"""Skeleton: the static articulated-tree spec, and the dynamics of one
skeleton.

Counterpart of nimblephysics_tpu/dynamics/skeleton.py: add_joint_and_body and
per-dof getters, and the single-world functions of one skeleton (forward
and full kinematics, point Jacobians, COMs, body parameters, RNEA
inverse dynamics, bias forces, the mass matrix, forward dynamics and
position integration). One joint per body, parents precede children.
Spatial vectors are [angular; linear] in each body's frame; gravity is a
fictitious base acceleration.

The functions run the batched arithmetic of batched/articulated.py on a
world of this skeleton alone with a batch of one: fk, RNEA, the mass
matrix as the sum of J_b^T G_b J_b over the bodies, and the exp-map
integration. The JAX package takes its bias force as Mdot v - grad(KE) -
g through nested jvp/grad; here it is RNEA at zero acceleration, the same
quantity (the JAX package tests the identity), so that the step needs no
nested differentiation. Body parameters ({"masses" (nb,), "coms" (nb, 3),
"inertias" (nb, 3, 3), "scales" (nb, 3)}, any subset) enter as the JAX
functions take them.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.dynamics import joints as J
from nimblephysics_tpu_torch.dynamics.joints import JointSpec
from nimblephysics_tpu_torch.dynamics.shapes import ShapeSpec
from nimblephysics_tpu_torch.math import lie
from nimblephysics_tpu_torch.math.spatial import spatial_inertia_matrix

DEFAULT_GRAVITY = np.array([0.0, 0.0, -9.81])


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
        # Mocap markers: name -> (body index, local offset (3,), fixed).
        self.markers: Dict[str, Tuple[int, np.ndarray, bool]] = {}

    def set_self_collision_check(self, enabled: bool) -> None:
        self.self_collision_enabled = bool(enabled)

    def set_adjacent_body_check(self, enabled: bool) -> None:
        self.adjacent_body_check = bool(enabled)

    def add_marker(self, name: str, body: int, offset, fixed: bool = False) -> None:
        """Attach a mocap marker at `offset` in body `body`'s frame;
        fixed: an anatomical marker (strongly offset-regularized)."""
        self.markers[name] = (int(body), np.asarray(offset, dtype=np.float64), bool(fixed))

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
        euler_order: str = "xyz",
        screw_pitch: float = 0.0,
        damping: Optional[Sequence] = None,
        spring_stiffness: Optional[Sequence] = None,
        rest_position: Optional[Sequence] = None,
        position_lower: Optional[Sequence] = None,
        position_upper: Optional[Sequence] = None,
        velocity_limit: Optional[Sequence] = None,
        force_limit: Optional[Sequence] = None,
        custom: Optional[J.CustomJointDef] = None,
        props: Optional[dict] = None,
    ) -> int:
        """Append a joint and its child body; returns the body index.
        custom: a CUSTOM joint's definition; props: a biomechanics
        joint's parameters (JointSpec.props)."""
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
            euler_order=euler_order,
            screw_pitch=float(screw_pitch),
            damping=_vec(damping),
            spring_stiffness=_vec(spring_stiffness),
            rest_position=_vec(rest_position),
            position_lower=_vec(position_lower),
            position_upper=_vec(position_upper),
            velocity_limit=_vec(velocity_limit),
            force_limit=_vec(force_limit),
            custom=custom,
            props=props,
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

    def body_index(self, name: str) -> int:
        for i, b in enumerate(self.bodies):
            if b.name == name:
                return i
        raise KeyError(name)

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


# ---------------------------------------------------------------------------
# The dynamics of one skeleton
# ---------------------------------------------------------------------------


class _Plan:
    """A skeleton's batched plan (the FlatWorld of a world holding it
    alone) and its constants as tensors, per dtype and device."""

    def __init__(self, skel: Skeleton):
        from nimblephysics_tpu_torch.batched.articulated import FlatWorld
        from nimblephysics_tpu_torch.simulation.world import World

        world = World(name=skel.name)
        world.skeletons.append(skel)
        self.fw = FlatWorld(world)
        self.skel = skel
        self.size = (skel.num_bodies, skel.num_dofs)
        self._t: Dict[Tuple, SimpleNamespace] = {}

    def consts(self, dtype, device) -> SimpleNamespace:
        key = (dtype, torch.device(device))
        if key not in self._t:
            sk = self.skel

            def t(x):
                return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                                       device=device)

            self._t[key] = SimpleNamespace(
                anc=t(self.fw.anc)[:, None, :],  # (nb, 1, nv)
                masses=t([b.mass for b in sk.bodies]),
                coms=t(np.stack([b.com for b in sk.bodies])),
                inertias=t(np.stack([b.inertia for b in sk.bodies])),
                damping=t(sk.damping_coeffs()),
                stiffness=t(sk.spring_stiffnesses()),
                rest=t(sk.rest_positions()),
            )
        return self._t[key]


def _plan(skel: Skeleton) -> _Plan:
    """The skeleton's plan, built at first use and again if bodies were
    added since."""
    plan = skel.__dict__.get("_plan")
    if plan is None or plan.size != (skel.num_bodies, skel.num_dofs):
        plan = _Plan(skel)
        skel._plan = plan
    return plan


def _col(x):
    return None if x is None else x[..., None]


def _fk(skel: Skeleton, q, scales=None):
    """The batched fk of the skeleton at q (nv,): R_wb, p_wb, W, S_list,
    rels with a batch of one."""
    from nimblephysics_tpu_torch.batched.articulated import fk

    return fk(_plan(skel).fw, q[:, None], _col(scales))


def _transforms(R_wb, p_wb):
    """fk's per-body (3, 3, 1), (3, 1) -> (nb, 4, 4)."""
    return lie.rp_to_transform(torch.stack([R[..., 0] for R in R_wb]),
                               torch.stack([p[:, 0] for p in p_wb]))


def _scaled(T, s):
    """T with its translation scaled by s (3,), out of place."""
    return lie.rp_to_transform(T[:3, :3], T[:3, 3] * s)


def relative_transform(spec: JointSpec, q_j, s_parent=None, s_child=None):
    """The child body's transform in its parent's frame, T_pj Q(q) T_cj^-1,
    with T_pj's translation scaled by the parent's scale and T_cj's by the
    child's (GROUP_SCALES)."""
    T_pj = torch.as_tensor(spec.T_pj, dtype=q_j.dtype, device=q_j.device)
    T_cj = torch.as_tensor(spec.T_cj, dtype=q_j.dtype, device=q_j.device)
    if s_parent is not None:
        T_pj = _scaled(T_pj, s_parent)
    if s_child is not None:
        T_cj = _scaled(T_cj, s_child)
    return T_pj @ J.joint_transform(spec, q_j) @ lie.transform_inv(T_cj)


def forward_kinematics(skel: Skeleton, q):
    """World transforms of every body, (nb, 4, 4)."""
    R_wb, p_wb, *_ = _fk(skel, q)
    return _transforms(R_wb, p_wb)


def full_kinematics(skel: Skeleton, q, dq=None, scales=None) -> Dict[str, torch.Tensor]:
    """FK and the world-frame system Jacobians in one pass: {"T_wb" (nb,
    4, 4), "J_world" (nb, 6, nv): the twist of each body about the world
    origin, Ad(T_wb) V_body = J_world dq}, and with dq, "V" (nb, 6): each
    body's twist in its own frame. scales (nb, 3): GROUP_SCALES."""
    R_wb, p_wb, W, *_ = _fk(skel, q, scales)
    T = _transforms(R_wb, p_wb)
    Jw = W[:, :, 0][None] * _plan(skel).consts(q.dtype, q.device).anc
    out = {"T_wb": T, "J_world": Jw}
    if dq is not None:
        out["V"] = (lie.Ad_inv(T) @ (Jw @ dq)[..., None])[..., 0]
    return out


def body_com_world(skel: Skeleton, q):
    """World position of each body's COM, (nb, 3)."""
    c = _plan(skel).consts(q.dtype, q.device)
    return lie.transform_point(forward_kinematics(skel, q), c.coms)


def com_world(skel: Skeleton, q):
    """The skeleton's mass-weighted COM, (3,)."""
    m = _plan(skel).consts(q.dtype, q.device).masses
    return (body_com_world(skel, q) * m[:, None]).sum(0) / m.sum()


def point_jacobian(J_world, point_world):
    """Linear-velocity Jacobian (3, nv) of a world point fixed to a body,
    from the body's world-frame Jacobian (6, nv): J[3:] - [p]x J[:3]."""
    return J_world[3:] - lie.skew(point_world) @ J_world[:3]


def default_body_params(skel: Skeleton, dtype=torch.float64, device="cpu"):
    """The body parameters at the spec's values: {"masses", "coms",
    "inertias"} (WithRespectToMass / GROUP_COMS / GROUP_INERTIAS)."""
    c = _plan(skel).consts(dtype, device)
    return {"masses": c.masses.clone(), "coms": c.coms.clone(),
            "inertias": c.inertias.clone()}


def _spatial_inertias(skel: Skeleton, dtype, body_params: Optional[Dict] = None,
                      device="cpu") -> List[torch.Tensor]:
    """Each body's 6x6 spatial inertia under body_params: masses without
    inertias scale the spec inertia by m / m0; scales multiply the COM by
    s and the inertia by s s^T."""
    c = _plan(skel).consts(dtype, device)
    bp = body_params or {}
    m, com, I, s = (bp.get(k) for k in ("masses", "coms", "inertias", "scales"))
    m = c.masses if m is None else m
    com = c.coms if com is None else com
    if I is None:
        I = c.inertias if bp.get("masses") is None else c.inertias * (m / c.masses)[:, None, None]
    if s is not None:
        com = com * s
        I = I * (s[:, :, None] * s[:, None, :])
    return list(spatial_inertia_matrix(m, com, I).unbind(0))


def _G_list(skel, q, body_params):
    """fk's per-body (6, 6, 1) spatial inertias under body_params, or None
    for the plan's own."""
    if not body_params:
        return None
    return [G[..., None] for G in _spatial_inertias(skel, q.dtype, body_params, q.device)]


def _base_acc(q, gravity):
    g = torch.as_tensor(DEFAULT_GRAVITY if gravity is None else gravity, dtype=q.dtype,
                        device=q.device)
    return torch.cat([torch.zeros_like(g), -g])[:, None]


def _rnea(skel, q, dq, fk_out, ddq=None, f_ext_body=None, gravity=None, body_params=None):
    from nimblephysics_tpu_torch.batched.articulated import bias_forces

    scales = (body_params or {}).get("scales")
    _, _, _, S_list, rels = fk_out
    return bias_forces(
        _plan(skel).fw, q[:, None], dq[:, None], rels, S_list,
        _G_list(skel, q, body_params), _col(scales), ddq=_col(ddq),
        f_ext=_col(f_ext_body), base_acc=_base_acc(q, gravity))[:, 0]


def inverse_dynamics(skel: Skeleton, q, dq, ddq, f_ext_body=None, gravity=None,
                     body_params=None):
    """Recursive Newton-Euler: the generalized forces of accelerations ddq.
    f_ext_body (nb, 6): external wrenches in each body's frame; gravity
    (3,): default (0, 0, -9.81)."""
    scales = (body_params or {}).get("scales")
    return _rnea(skel, q, dq, _fk(skel, q, scales), ddq, f_ext_body, gravity, body_params)


def bias_forces(skel: Skeleton, q, dq, f_ext_body=None, gravity=None, body_params=None):
    """C(q, dq) with gravity and the external wrenches: RNEA at zero
    acceleration."""
    return inverse_dynamics(skel, q, dq, torch.zeros_like(dq), f_ext_body=f_ext_body,
                            gravity=gravity, body_params=body_params)


def _mass(skel, q, fk_out, body_params):
    from nimblephysics_tpu_torch.batched.articulated import mass_matrix_blocks

    R_wb, p_wb, W, *_ = fk_out
    return mass_matrix_blocks(_plan(skel).fw, R_wb, p_wb, W,
                              _G_list(skel, q, body_params))[0][..., 0]


def mass_matrix(skel: Skeleton, q, body_params=None):
    """The joint-space inertia M(q), (nv, nv), symmetric positive
    definite: sum over the bodies of J_b^T G_b J_b."""
    scales = (body_params or {}).get("scales")
    return _mass(skel, q, _fk(skel, q, scales), body_params)


def mass_and_bias_fused(skel: Skeleton, q, v, gravity=None, body_params=None):
    """(M, bias, kin) from one kinematics pass: M as mass_matrix, the bias
    by RNEA at zero acceleration, kin = {"T_wb", "J_world"}."""
    scales = (body_params or {}).get("scales")
    fk_out = _fk(skel, q, scales)
    R_wb, p_wb, W, *_ = fk_out
    kin = {"T_wb": _transforms(R_wb, p_wb),
           "J_world": W[:, :, 0][None] * _plan(skel).consts(q.dtype, q.device).anc}
    M = _mass(skel, q, fk_out, body_params)
    bias = _rnea(skel, q, v, fk_out, gravity=gravity, body_params=body_params)
    return M, bias, kin


def passive_forces(skel: Skeleton, q, dq):
    """Joint damping and spring forces, -d dq - k (q - q_rest)."""
    c = _plan(skel).consts(q.dtype, q.device)
    return -c.damping * dq - c.stiffness * (q - c.rest)


def forward_dynamics(skel: Skeleton, q, dq, tau, f_ext_body=None, gravity=None,
                     body_params=None):
    """ddq = M^-1 (tau + passive - C): the smooth, constraint-free
    dynamics, by a Cholesky solve."""
    M = mass_matrix(skel, q, body_params=body_params)
    C = bias_forces(skel, q, dq, f_ext_body=f_ext_body, gravity=gravity,
                    body_params=body_params)
    rhs = tau + passive_forces(skel, q, dq) - C
    return torch.cholesky_solve(rhs[:, None], torch.linalg.cholesky(M))[:, 0]


def integrate_positions(skel: Skeleton, q, dq, dt):
    """Explicit position integration of every joint (exp-map composition
    for ball and free joints)."""
    from nimblephysics_tpu_torch.batched.articulated import integrate_positions as ip

    return ip(_plan(skel).fw, q[:, None], dq[:, None], dt)[:, 0]

"""Carry a world and a state across from plain arrays.

`world_from_arrays(spec)` builds this package's World from a nested dict
of plain numbers and numpy arrays, so that a world defined elsewhere (the
JAX package's, dumped field by field) steps here with the same
parameters. `state_to_torch` moves an (nv, B) state and (n, B)
impulses onto a device. `policy_from_arrays` carries an MLP policy's
weights across (the pytree {w1, b1, w2, b2} of bench.py's policy).

Spec layout (every array-like is converted with np.asarray):

    {"name": str, "gravity": (3,), "time_step": float,
     "solver": {SolverConfig field: value, ...},
     "parallel_velocity_and_position_updates": bool,
     "action_indices": (na,) or None,
     "collision_overrides": [(body_i, body_j, collide: bool), ...],
     "actuator_types": {dof: {"kind", "force_limit", "mimic_dof",
                              "mimic_multiplier", "mimic_offset"}, ...},
     "dynamic_constraints": [{"kind": "ball", "body_a", "offset_a" (3,),
                              "body_b", "offset_b" (3,)} or
                             {"kind": "weld", "body_a", "body_b",
                              "rel_rot" (3,3), "offset_a" (3,),
                              "offset_b" (3,)}, ...],
     "skeletons": [
        {"name": str, "self_collision": bool, "adjacent_body_check": bool,
         "joints": [{"type", "parent", "name", "T_pj" (4,4), "T_cj" (4,4),
                     "axes" (k,3) or None, "euler_order", "screw_pitch",
                     "damping", "spring_stiffness",
                     "rest_position", "position_lower", "position_upper",
                     "velocity_limit", "force_limit": (nd,) or None,
                     "props": dict or None,
                     "custom": {"n_dofs", "rot_axes" (3,3),
                                "trans_axes" (3,3), "drives" (6,),
                                "functions": [(kind, params, scale)] x 6}
                               or None}],
         "bodies": [{"mass", "com" (3,), "inertia" (3,3),
                     "shapes": [{"type", "size", "T_offset" (4,4),
                                 "friction", "restitution",
                                 "collidable", "mesh_vertices" (n,3),
                                 "heights" (H,W), "spheres" (N,4)}]}]}]}

Joint i of a skeleton carries body i. Joint types are the names of
dynamics/joints.py, and both engines take all of them; "props" holds a
biomechanics joint's parameters (ellipsoid, scapulathoracic,
constantcurve, constantcurveincompressible) and "custom" a custom
joint's definition, each function as math/splines.Fn's (kind, params,
scale). Shape types are those of dynamics/shapes.py, with their `size`:
"box" full side lengths (3,), "plane" [nx, ny, nz, offset], "sphere"
[radius], "capsule" [radius, height], "heightmap" [sx, sy, sz] with
"heights"; "mesh" takes "mesh_vertices" and "multisphere" "spheres" (rows
[cx, cy, cz, radius]). collision_overrides and dynamic_constraints name global body
indices (bodies counted across the skeletons in order); False filters a
pair, True forces it. A weld entry carries the relative rotation and
anchor offsets captured where it was made (World.add_weld_joint_constraint).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.dynamics.joints import CustomJointDef
from nimblephysics_tpu_torch.dynamics.shapes import ShapeSpec
from nimblephysics_tpu_torch.dynamics.skeleton import Skeleton
from nimblephysics_tpu_torch.math.splines import Fn
from nimblephysics_tpu_torch.parallel.mesh import MlpPolicy
from nimblephysics_tpu_torch.simulation.world import SolverConfig, World

_JOINT_VECTORS = (
    "damping", "spring_stiffness", "rest_position", "position_lower",
    "position_upper", "velocity_limit", "force_limit",
)


_SHAPE_ARRAYS = ("mesh_vertices", "heights", "spheres")


def _custom(cd: Optional[dict]) -> Optional[CustomJointDef]:
    """A custom joint's definition from its plain-array form."""
    if cd is None:
        return None
    fns = tuple(
        Fn(kind, tuple(np.asarray(p, np.float64) if np.ndim(p) else float(p) for p in params),
           float(scale))
        for kind, params, scale in cd["functions"])
    return CustomJointDef(
        n_dofs=int(cd["n_dofs"]),
        rot_axes=np.asarray(cd["rot_axes"], np.float64),
        trans_axes=np.asarray(cd["trans_axes"], np.float64),
        functions=fns,
        drives=tuple(int(d) for d in cd["drives"]),
    )


def world_from_arrays(spec: dict) -> World:
    """Build a World from the plain-array spec described above."""
    world = World(
        name=spec.get("name", "world"),
        gravity=np.asarray(spec["gravity"], dtype=np.float64),
        time_step=float(spec["time_step"]),
        solver=SolverConfig(**spec.get("solver", {})),
    )
    world.parallel_velocity_and_position_updates = bool(
        spec.get("parallel_velocity_and_position_updates", True)
    )
    for sk in spec["skeletons"]:
        skel = Skeleton(sk.get("name", "skeleton"))
        skel.set_self_collision_check(sk.get("self_collision", False))
        skel.set_adjacent_body_check(sk.get("adjacent_body_check", False))
        if len(sk["joints"]) != len(sk["bodies"]):
            raise ValueError("a skeleton needs one joint per body")
        for jd, bd in zip(sk["joints"], sk["bodies"]):
            shapes = tuple(
                ShapeSpec(
                    sd["type"],
                    np.asarray(sd["size"], dtype=np.float64),
                    T_offset=np.asarray(sd.get("T_offset", np.eye(4)), np.float64),
                    friction=float(sd.get("friction", 1.0)),
                    restitution=float(sd.get("restitution", 0.0)),
                    collidable=bool(sd.get("collidable", True)),
                    **{k: None if sd.get(k) is None else np.asarray(sd[k], np.float64)
                       for k in _SHAPE_ARRAYS},
                )
                for sd in bd.get("shapes", ())
            )
            skel.add_joint_and_body(
                jd["type"],
                parent=int(jd.get("parent", -1)),
                name=jd.get("name"),
                T_pj=jd.get("T_pj"),
                T_cj=jd.get("T_cj"),
                axes=jd.get("axes"),
                euler_order=jd.get("euler_order", "xyz"),
                screw_pitch=float(jd.get("screw_pitch", 0.0)),
                mass=float(bd["mass"]),
                com=np.asarray(bd["com"], dtype=np.float64),
                inertia=np.asarray(bd["inertia"], dtype=np.float64),
                shapes=shapes,
                custom=_custom(jd.get("custom")),
                props=jd.get("props"),
                **{k: jd.get(k) for k in _JOINT_VECTORS},
            )
        world.add_skeleton(skel)
    if spec.get("action_indices") is not None:
        world.set_action_space(spec["action_indices"])
    for i, j, collide in spec.get("collision_overrides", ()):
        world.collision_overrides[(int(i), int(j))] = bool(collide)
    for dof, act in spec.get("actuator_types", {}).items():
        world.set_actuator_type(int(dof), **act)
    for con in spec.get("dynamic_constraints", ()):
        world.dynamic_constraints.append(
            {k: (x if isinstance(x, str) else int(x) if k.startswith("body")
                 else np.asarray(x, dtype=np.float64)) for k, x in con.items()})
    return world


def state_to_torch(
    q, v, z=None, device="cuda", dtype: torch.dtype = torch.float32
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(nv, B) positions and velocities and optional (n, B) impulses, as
    numpy or array-likes, -> contiguous tensors on `device` in `dtype`."""

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device).contiguous()

    return t(q), t(v), None if z is None else t(z)


def policy_from_arrays(w1, b1, w2, b2, device="cuda",
                       dtype: torch.dtype = torch.float32) -> MlpPolicy:
    """An MlpPolicy holding the given weights: w1 (hidden, 2nv),
    b1 (hidden, 1), w2 (na, hidden), b2 (na, 1), as numpy or array-likes,
    on `device` in `dtype`."""
    w1, b1, w2, b2 = (np.asarray(x) for x in (w1, b1, w2, b2))
    hidden, state_size = w1.shape
    policy = MlpPolicy(state_size, w2.shape[0], hidden, device=device, dtype=dtype)
    with torch.no_grad():
        for p, x in zip((policy.w1, policy.b1, policy.w2, policy.b2),
                        (w1, b1, w2, b2)):
            if tuple(p.shape) != x.shape:
                raise ValueError(f"weight of shape {x.shape}, expected {tuple(p.shape)}")
            p.copy_(torch.as_tensor(x, dtype=dtype))
    return policy

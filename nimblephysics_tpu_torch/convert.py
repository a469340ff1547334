"""Carry a world and a state across from plain arrays.

`world_from_arrays(spec)` builds this package's World from a nested dict
of plain numbers and numpy arrays, so that a world defined elsewhere (the
JAX package's, dumped field by field) steps here with the same
parameters. `state_to_torch` moves an (nv, B) state and (n, B)
impulses onto a device.

Spec layout (every array-like is converted with np.asarray):

    {"name": str, "gravity": (3,), "time_step": float,
     "solver": {SolverConfig field: value, ...},
     "parallel_velocity_and_position_updates": bool,
     "action_indices": (na,) or None,
     "skeletons": [
        {"name": str, "self_collision": bool, "adjacent_body_check": bool,
         "joints": [{"type", "parent", "name", "T_pj" (4,4), "T_cj" (4,4),
                     "axes" (k,3) or None, "damping", "spring_stiffness",
                     "rest_position", "position_lower", "position_upper",
                     "velocity_limit", "force_limit": (nd,) or None}],
         "bodies": [{"mass", "com" (3,), "inertia" (3,3),
                     "shapes": [{"type", "size", "T_offset" (4,4),
                                 "friction", "restitution",
                                 "collidable"}]}]}]}

Joint i of a skeleton carries body i.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.dynamics.shapes import ShapeSpec
from nimblephysics_tpu_torch.dynamics.skeleton import Skeleton
from nimblephysics_tpu_torch.simulation.world import SolverConfig, World

_JOINT_VECTORS = (
    "damping", "spring_stiffness", "rest_position", "position_lower",
    "position_upper", "velocity_limit", "force_limit",
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
                mass=float(bd["mass"]),
                com=np.asarray(bd["com"], dtype=np.float64),
                inertia=np.asarray(bd["inertia"], dtype=np.float64),
                shapes=shapes,
                **{k: jd.get(k) for k in _JOINT_VECTORS},
            )
        world.add_skeleton(skel)
    if spec.get("action_indices") is not None:
        world.set_action_space(spec["action_indices"])
    return world


def state_to_torch(
    q, v, z=None, device="cuda", dtype: torch.dtype = torch.float32
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(nv, B) positions and velocities and optional (n, B) impulses, as
    numpy or array-likes, -> contiguous tensors on `device` in `dtype`."""

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device).contiguous()

    return t(q), t(v), None if z is None else t(z)

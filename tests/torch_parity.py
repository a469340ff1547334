"""Helpers shared by the tests that hold nimblephysics_tpu_torch against
the JAX package: world dumps, seeded inputs and array conversion.

Inputs are made with numpy from a seed and handed to both sides; arrays
cross between the frameworks as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

F64 = dict(device="cpu", dtype=torch.float64)


def dump_world(world) -> dict:
    """A JAX-package World as the plain-array spec that
    nimblephysics_tpu_torch.convert.world_from_arrays reads."""
    skels = []
    for s in world.skeletons:
        joints = [
            dict(
                type=j.joint_type,
                parent=j.parent,
                name=b.name,
                T_pj=np.asarray(j.T_pj),
                T_cj=np.asarray(j.T_cj),
                axes=None if j.axes is None else np.asarray(j.axes),
                damping=j.damping,
                spring_stiffness=j.spring_stiffness,
                rest_position=j.rest_position,
                position_lower=j.position_lower,
                position_upper=j.position_upper,
                velocity_limit=j.velocity_limit,
                force_limit=j.force_limit,
            )
            for j, b in zip(s.joints, s.bodies)
        ]
        bodies = [
            dict(
                mass=b.mass,
                com=np.asarray(b.com),
                inertia=np.asarray(b.inertia),
                shapes=[
                    dict(
                        type=sh.shape_type,
                        size=np.asarray(sh.size),
                        T_offset=np.asarray(sh.T_offset),
                        friction=sh.friction,
                        restitution=sh.restitution,
                        collidable=sh.collidable,
                    )
                    for sh in b.shapes
                ],
            )
            for b in s.bodies
        ]
        skels.append(
            dict(
                name=s.name,
                self_collision=s.self_collision_enabled,
                adjacent_body_check=s.adjacent_body_check,
                joints=joints,
                bodies=bodies,
            )
        )
    return dict(
        name=world.name,
        gravity=np.asarray(world.gravity),
        time_step=world.time_step,
        solver=dataclasses.asdict(world.solver),
        parallel_velocity_and_position_updates=(
            world.parallel_velocity_and_position_updates
        ),
        action_indices=np.asarray(world.action_indices),
        skeletons=skels,
    )


def half_cheetah_pair():
    """(JAX world, port world, q0), both under SolverConfig.throughput()."""
    from nimblephysics_tpu.models import half_cheetah as jax_hc
    from nimblephysics_tpu.simulation.world import SolverConfig as JaxCfg

    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.simulation import SolverConfig

    jw, q0, _ = jax_hc()
    jw.solver = JaxCfg.throughput()
    tw, _, _ = half_cheetah()
    tw.solver = SolverConfig.throughput()
    return jw, tw, np.asarray(q0, np.float64)


def batch_states(q0, B, seed, drop=0.0, spread=0.03):
    """Seeded (nv, B) q, v, u around q0 with the root height shifted by
    `drop` (tests/test_batched.py::_batch_states)."""
    rng = np.random.RandomState(seed)
    nv = len(q0)
    q = np.tile(q0[:, None], (1, B)) + spread * rng.randn(nv, B)
    q[1] += drop
    v = 0.3 * rng.randn(nv, B)
    u = 0.3 * rng.randn(nv, B)
    return q, v, u


def t64(x):
    return torch.as_tensor(np.array(x), **F64)


def n(x):
    """torch or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

"""World: skeletons, gravity, time step and solver config (static spec),
and the world-level functions of one world.

Counterpart of nimblephysics_tpu/simulation/world.py: SolverConfig (with
the throughput() preset), dof/body bookkeeping across skeletons, the
action space, limits, actuator types and the user-added weld and ball
constraints; split_state/merge_state and the per-skeleton kinematics,
mass matrix, forward dynamics and position integration concatenated over
the world. Stepping lives in neural/timestep.py (one world) and
batched/engine.py (a batch).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from nimblephysics_tpu_torch.dynamics import skeleton as SK
from nimblephysics_tpu_torch.dynamics.skeleton import Skeleton, _unique_name


@dataclasses.dataclass(frozen=True, eq=False)
class SolverConfig:
    """Contact/LCP solver knobs (defaults mirror the reference).

    Reference parity: ContactConstraint statics (ERP 0.01, max ERV 1e-3,
    bounce threshold 0.1, max bounce 100, friction/restitution activation
    thresholds 1e-3) and World knobs (penetration correction off, contact
    clipping depth 0.03, fallback CFM 1e-4).
    """

    lcp_solver: str = "apgd"
    lcp_iterations: int = 32
    lcp_refine_rounds: int = 3
    lcp_seed_pgs_sweeps: int = 16
    cfm: float = 0.0
    fallback_cfm: float = 1e-4
    # False: ladder-resolved worlds keep their forward impulse but carry
    # no impulse gradient (the reference differentiates the fallback).
    fallback_gradients: bool = False
    ladder_mode: str = "lazy"
    error_allowance: float = 0.0
    error_reduction_parameter: float = 0.01
    max_error_reduction_velocity: float = 1e-3
    joint_max_error_reduction_velocity: float = 10.0
    bouncing_velocity_threshold: float = 0.1
    max_bouncing_velocity: float = 100.0
    friction_threshold: float = 1e-3
    restitution_threshold: float = 1e-3
    penetration_correction_enabled: bool = False
    contact_clipping_depth: float = 0.03
    joint_limit_margin: float = 0.0
    contact_islands: bool = True
    contact_cap: Optional[int] = None

    @classmethod
    def throughput(cls, **overrides) -> "SolverConfig":
        """Preset for large-batch rollouts: the failure ladder runs on every
        step with per-world selection, no PGS polish on the seed, two
        refine rounds and 24 APGD iterations."""
        cfg = dict(
            ladder_mode="always",
            lcp_seed_pgs_sweeps=0,
            lcp_refine_rounds=2,
            lcp_iterations=24,
        )
        cfg.update(overrides)
        return cls(**cfg)


class World:
    """Static world spec (state layout [positions; velocities], action =
    control forces on `action_indices`)."""

    def __init__(
        self,
        name: str = "world",
        gravity: Sequence[float] = (0.0, 0.0, -9.81),
        time_step: float = 0.001,
        solver: Optional[SolverConfig] = None,
    ):
        self.name = name
        self.gravity = np.asarray(gravity, dtype=np.float64)
        self.time_step = float(time_step)
        self.solver = solver or SolverConfig()
        self.skeletons: List[Skeleton] = []
        self._action_indices: Optional[np.ndarray] = None
        # User-added weld/ball constraints, plan entries as in the JAX
        # package (add_ball_joint_constraint, add_weld_joint_constraint).
        self.dynamic_constraints: List[dict] = []
        self.actuator_types: Dict[int, dict] = {}
        # Reference integration scheme (World.cpp:82): q_{t+1} integrates
        # the pre-step velocity.
        self.parallel_velocity_and_position_updates = True
        self.max_contacts: Optional[int] = None
        # Gradient debug modes (World.hpp:700-713, setUseFDOverride /
        # setSlowDebugResultsAgainstFD), read by
        # BackpropSnapshot.get_state_jacobian: the FD override returns the
        # finite-difference Jacobian; slow-debug computes both and raises
        # with a repro when they differ by more than fd_debug_tolerance.
        self.use_fd_override = False
        self.slow_debug_results_against_fd = False
        self.fd_debug_tolerance = 1e-5
        self.collision_overrides: Dict[Tuple[int, int], bool] = {}

    def add_skeleton(self, skel: Skeleton) -> int:
        skel.name = _unique_name(
            skel.name, {s.name for s in self.skeletons}
        )
        self.skeletons.append(skel)
        return len(self.skeletons) - 1

    def add_ball_joint_constraint(self, body_a: int, offset_a, body_b: int,
                                  offset_b) -> None:
        """Hold the point offset_a of body_a to the point offset_b of
        body_b (body frames; global body indices)."""
        self.dynamic_constraints.append(dict(
            kind="ball",
            body_a=int(body_a),
            offset_a=np.asarray(offset_a, dtype=np.float64),
            body_b=int(body_b),
            offset_b=np.asarray(offset_b, dtype=np.float64),
        ))

    def add_weld_joint_constraint(self, body_a: int, body_b: int,
                                  at_positions=None) -> None:
        """Weld body_b to body_a in their relative pose at `at_positions`
        (the zero pose by default), anchored at body_b's origin. The pose
        comes from the batched forward kinematics on the CPU in float64."""
        import torch

        from nimblephysics_tpu_torch.batched.articulated import FlatWorld, fk

        q0 = (np.zeros(self.num_dofs) if at_positions is None
              else np.asarray(at_positions, dtype=np.float64))
        R, p, *_ = fk(FlatWorld(self), torch.as_tensor(q0, dtype=torch.float64)[:, None])
        RA, RB = (R[int(b)][..., 0].numpy() for b in (body_a, body_b))
        pA, pB = (p[int(b)][:, 0].numpy() for b in (body_a, body_b))
        self.dynamic_constraints.append(dict(
            kind="weld",
            body_a=int(body_a),
            body_b=int(body_b),
            rel_rot=RA.T @ RB,
            offset_a=RA.T @ (pB - pA),
            offset_b=np.zeros(3),
        ))

    def set_actuator_type(
        self,
        dof: int,
        kind: str,
        force_limit: float = np.inf,
        mimic_dof: Optional[int] = None,
        mimic_multiplier: float = 1.0,
        mimic_offset: float = 0.0,
    ) -> None:
        if kind not in ("force", "servo", "mimic", "locked", "passive"):
            raise ValueError(f"unknown actuator kind {kind!r}")
        self.actuator_types[int(dof)] = dict(
            kind=kind,
            force_limit=float(force_limit),
            mimic_dof=mimic_dof,
            mimic_multiplier=float(mimic_multiplier),
            mimic_offset=float(mimic_offset),
        )

    def dof_actuator(self, dof: int) -> dict:
        return self.actuator_types.get(
            dof,
            dict(kind="force", force_limit=np.inf, mimic_dof=None,
                 mimic_multiplier=1.0, mimic_offset=0.0),
        )

    @property
    def num_dofs(self) -> int:
        return sum(s.num_dofs for s in self.skeletons)

    @property
    def num_bodies(self) -> int:
        return sum(s.num_bodies for s in self.skeletons)

    def dof_offsets(self) -> List[int]:
        return [s for s, _ in self.dof_slices()]

    def body_offsets(self) -> List[int]:
        offs, c = [], 0
        for s in self.skeletons:
            offs.append(c)
            c += s.num_bodies
        return offs

    def dof_slices(self) -> List[Tuple[int, int]]:
        out, c = [], 0
        for s in self.skeletons:
            out.append((c, c + s.num_dofs))
            c += s.num_dofs
        return out

    def set_action_space(self, indices: Sequence[int]) -> None:
        self._action_indices = np.asarray(indices, dtype=np.int32)

    @property
    def action_indices(self) -> np.ndarray:
        if self._action_indices is None:
            return np.arange(self.num_dofs, dtype=np.int32)
        return self._action_indices

    @property
    def action_size(self) -> int:
        return len(self.action_indices)

    @property
    def state_size(self) -> int:
        return 2 * self.num_dofs

    def action_to_forces(self, action: torch.Tensor) -> torch.Tensor:
        """Scatter an action vector (na,) into the control forces (nv,)."""
        idx = torch.as_tensor(self.action_indices.astype(np.int64), device=action.device)
        return action.new_zeros(self.num_dofs).index_copy(0, idx, action)

    def forces_to_action(self, tau: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(self.action_indices.astype(np.int64), device=tau.device)
        return tau[idx]

    def _per_dof(self, getter) -> np.ndarray:
        if not self.skeletons:
            return np.zeros(0)
        return np.concatenate([getter(s) for s in self.skeletons])

    def position_lower_limits(self) -> np.ndarray:
        return self._per_dof(Skeleton.position_lower_limits)

    def position_upper_limits(self) -> np.ndarray:
        return self._per_dof(Skeleton.position_upper_limits)

    def force_limits(self) -> np.ndarray:
        return self._per_dof(Skeleton.force_limits)

    def velocity_limits(self) -> np.ndarray:
        return self._per_dof(Skeleton.velocity_limits)

    def __repr__(self):
        return (
            f"World({self.name!r}, skeletons={len(self.skeletons)}, "
            f"dofs={self.num_dofs})"
        )


# ---------------------------------------------------------------------------
# World-level functions of one world (per-skeleton quantities concatenated)
# ---------------------------------------------------------------------------


def split_state(world: World, state: torch.Tensor):
    nv = world.num_dofs
    return state[:nv], state[nv:]


def merge_state(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, v])


def _widen(J, s, e, nv):
    """A skeleton's (..., nd) Jacobian columns placed at dofs [s, e) of
    nv."""
    return torch.cat([J.new_zeros(*J.shape[:-1], s), J,
                      J.new_zeros(*J.shape[:-1], nv - e)], dim=-1)


def world_fk(world: World, q: torch.Tensor) -> torch.Tensor:
    """World transforms of every body across the skeletons, (NB, 4, 4)."""
    return torch.cat([SK.forward_kinematics(sk, q[s:e])
                      for sk, (s, e) in zip(world.skeletons, world.dof_slices())])


def world_full_kinematics(world: World, q: torch.Tensor, dq: torch.Tensor):
    """FK, body twists and world-width system Jacobians of every body:
    {"T_wb" (NB, 4, 4), "V" (NB, 6), "J_world" (NB, 6, nv)}."""
    nv = world.num_dofs
    T, V, Jw = [], [], []
    for sk, (s, e) in zip(world.skeletons, world.dof_slices()):
        kin = SK.full_kinematics(sk, q[s:e], dq[s:e])
        T.append(kin["T_wb"])
        V.append(kin["V"])
        Jw.append(_widen(kin["J_world"], s, e, nv))
    return {"T_wb": torch.cat(T), "V": torch.cat(V), "J_world": torch.cat(Jw)}


def world_mass_matrix(world: World, q: torch.Tensor) -> torch.Tensor:
    """The block-diagonal world mass matrix (nv, nv)."""
    return torch.block_diag(*[SK.mass_matrix(sk, q[s:e])
                              for sk, (s, e) in zip(world.skeletons, world.dof_slices())])


def world_forward_dynamics(world: World, q, dq, tau) -> torch.Tensor:
    """Unconstrained accelerations, skeleton by skeleton, under the world's
    gravity."""
    return torch.cat([
        SK.forward_dynamics(sk, q[s:e], dq[s:e], tau[s:e], gravity=world.gravity)
        for sk, (s, e) in zip(world.skeletons, world.dof_slices())])


def world_integrate_positions(world: World, q, dq, dt) -> torch.Tensor:
    return torch.cat([SK.integrate_positions(sk, q[s:e], dq[s:e], dt)
                      for sk, (s, e) in zip(world.skeletons, world.dof_slices())])

"""Mappings: alternate loss spaces over world state.

Counterpart of nimblephysics_tpu/neural/mappings.py. Reference parity:
dart/neural/Mapping.hpp:80-127 (map world state to body-space
positions/velocities with Jacobians both ways), IKMapping (IKMapping.hpp:53
— addSpatialBodyNode/addLinearBodyNode/addAngularBodyNode),
IdentityMapping, and the python-side map_to_pos / map_to_vel autograd
functions (python/nimblephysics/mapping.py:8-94).

A mapping is a pure function of (q, v) on FK (simulation/world.py::
world_fk): map_vel is its forward-mode derivative (torch.func.jvp), its
Jacobian torch.func.jacfwd, and the inverse map (setState in mapped
space) damped Gauss-Newton through that Jacobian. Everything
differentiates with torch autograd.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from nimblephysics_tpu_torch.math import lie
from nimblephysics_tpu_torch.simulation.world import World, world_fk


class IdentityMapping:
    """Reference parity: neural::IdentityMapping — mapped space == world
    joint space."""

    def __init__(self, world: World):
        self.world = world

    @property
    def pos_dim(self):
        return self.world.num_dofs

    def map_pos(self, q):
        return q

    def map_vel(self, q, v):
        return v

    def map_pos_jacobian(self, q):
        return torch.eye(self.world.num_dofs, dtype=q.dtype, device=q.device)


def _body_coords(T, entries):
    """Stacked coordinates of the entries' bodies from their world
    transforms T (NB, 4, 4): spatial = [log(R); p], linear = p, angular =
    log(R)."""
    parts = []
    for kind, b in entries:
        if kind == IKMapping.SPATIAL:
            parts += [lie.log_map_rot(T[b, :3, :3]), T[b, :3, 3]]
        elif kind == IKMapping.LINEAR:
            parts.append(T[b, :3, 3])
        elif kind == IKMapping.ANGULAR:
            parts.append(lie.log_map_rot(T[b, :3, :3]))
    return torch.cat(parts)


class IKMapping:
    """Body-space mapping: stack spatial/linear/angular coordinates of
    chosen bodies (reference: neural::IKMapping, IKMapping.hpp:53)."""

    SPATIAL = "spatial"
    LINEAR = "linear"
    ANGULAR = "angular"
    COM = "com"

    def __init__(self, world: World):
        self.world = world
        self.entries: List[Tuple[str, int]] = []

    def add_spatial_body_node(self, body_index: int):
        self.entries.append((self.SPATIAL, body_index))
        return self

    def add_linear_body_node(self, body_index: int):
        self.entries.append((self.LINEAR, body_index))
        return self

    def add_angular_body_node(self, body_index: int):
        self.entries.append((self.ANGULAR, body_index))
        return self

    @property
    def pos_dim(self) -> int:
        return sum(6 if k == self.SPATIAL else 3 for k, _ in self.entries)

    # -- forward maps --------------------------------------------------------

    def map_pos(self, q: torch.Tensor) -> torch.Tensor:
        """World positions -> mapped positions (body poses)."""
        return _body_coords(world_fk(self.world, q), self.entries)

    def map_vel(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """World velocities -> mapped velocities (exact: jvp of map_pos)."""
        return torch.func.jvp(self.map_pos, (q,), (v,))[1]

    # -- Jacobians (reference: Mapping::getRealPosToMappedPosJac etc.) ------

    def map_pos_jacobian(self, q: torch.Tensor) -> torch.Tensor:
        return torch.func.jacfwd(self.map_pos)(q)

    def inverse_map_pos(
        self, target: torch.Tensor, q_init: torch.Tensor,
        iterations: int = 20, damping: float = 1e-6
    ) -> torch.Tensor:
        """Mapped positions -> world positions: `iterations` damped
        Gauss-Newton steps of IK (reference analog: the setPositions path
        of IKMapping, which runs an IK solve)."""
        q = q_init
        for _ in range(iterations):
            r = self.map_pos(q) - target
            J = self.map_pos_jacobian(q)
            JtJ = J.T @ J + damping * torch.eye(J.shape[1], dtype=q.dtype, device=q.device)
            q = q - torch.linalg.solve(JtJ, J.T @ r)
        return q


def map_to_pos(world: World, mapping, state: torch.Tensor) -> torch.Tensor:
    """Reference parity: nimble.map_to_pos (python/nimblephysics/
    mapping.py:8) — mapped positions of a world state; differentiable."""
    nv = world.num_dofs
    return mapping.map_pos(state[:nv])


def map_to_vel(world: World, mapping, state: torch.Tensor) -> torch.Tensor:
    """Reference parity: nimble.map_to_vel (mapping.py:50)."""
    nv = world.num_dofs
    return mapping.map_vel(state[:nv], state[nv:])


def convert_joint_space_to_world_space(
    world: World, q_trajectory: torch.Tensor, body_indices=None, what="pos"
) -> torch.Tensor:
    """Batch conversion of joint trajectories to world-space body poses.

    Reference parity: neural::convertJointSpaceToWorldSpace
    (NeuralUtils.hpp:88-140). q_trajectory: (T, nq) -> (T, 3*nb or 6*nb).
    Differentiable with torch autograd.
    """
    if body_indices is None:
        body_indices = list(range(world.num_bodies))
    kind = {"pos": IKMapping.LINEAR, "spatial": IKMapping.SPATIAL}[what]
    entries = [(kind, b) for b in body_indices]
    return torch.func.vmap(lambda q: _body_coords(world_fk(world, q), entries))(q_trajectory)


class RestorableSnapshot:
    """Reference parity: neural::RestorableSnapshot
    (RestorableSnapshot.hpp:19) — in a functional engine state never
    mutates, so this is a plain value capture kept for API familiarity."""

    def __init__(self, world: World, state: torch.Tensor):
        self.world = world
        self.state = state

    def restore(self) -> torch.Tensor:
        return self.state

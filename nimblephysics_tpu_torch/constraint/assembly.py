"""Constraint row plan: contacts, joint limits, motors -> LcpMeta.

Counterpart of the static half of ConstraintAssembler in
nimblephysics_tpu/constraint/assembly.py. Row layout: 3 rows per contact
slot [normal, tangent1, tangent2], then one row per finite position
limit [lower, upper per dof], then motor rows, then dynamic-joint rows.
The batched engine assembles the rows' values (batched/engine.py).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from nimblephysics_tpu_torch.collision.collider import Collider
from nimblephysics_tpu_torch.constraint.lcp import LcpMeta
from nimblephysics_tpu_torch.simulation.world import World


@dataclasses.dataclass(frozen=True, eq=False)
class _LimitRow:
    dof: int  # world dof index
    sign: float  # +1: lower limit, -1: upper limit
    limit: float


class ConstraintAssembler:
    """Static row plan for one World."""

    def __init__(self, world: World, collider: Collider):
        self.world = world
        self.collider = collider
        self.num_contacts = collider.num_contacts

        self.limit_rows: List[_LimitRow] = []
        lo = world.position_lower_limits()
        hi = world.position_upper_limits()
        for d in range(world.num_dofs):
            if np.isfinite(lo[d]):
                self.limit_rows.append(_LimitRow(d, +1.0, float(lo[d])))
            if np.isfinite(hi[d]):
                self.limit_rows.append(_LimitRow(d, -1.0, float(hi[d])))

        # One force-limited row per servo/mimic/locked dof.
        self.motor_rows: List[dict] = []
        for d in range(world.num_dofs):
            act = world.dof_actuator(d)
            if act["kind"] in ("servo", "mimic", "locked"):
                self.motor_rows.append(dict(dof=d, **act))

        self.dyn_rows = sum(
            6 if con["kind"] == "weld" else 3
            for con in world.dynamic_constraints
        )

        C = self.num_contacts
        L = len(self.limit_rows)
        Mrows = len(self.motor_rows)
        n = 3 * C + L + Mrows + self.dyn_rows
        findex = np.full(n, -1, dtype=np.int32)
        is_friction = np.zeros(n, dtype=bool)
        for c in range(C):
            findex[3 * c + 1] = 3 * c
            findex[3 * c + 2] = 3 * c
            is_friction[3 * c + 1] = True
            is_friction[3 * c + 2] = True
        # Contacts/limits [0, inf); motor rows +-force_limit*dt; dynamic
        # joint rows are equalities.
        lo_const = np.zeros(n)
        hi_const = np.full(n, np.inf)
        dt = world.time_step
        base = 3 * C + L
        for i, mr in enumerate(self.motor_rows):
            lim = mr["force_limit"] * dt
            lo_const[base + i] = -lim
            hi_const[base + i] = lim
        lo_const[base + Mrows:] = -np.inf
        has_boxes = Mrows > 0 or self.dyn_rows > 0
        self.meta = LcpMeta(
            findex=findex,
            is_friction=is_friction,
            lo_const=lo_const if has_boxes else None,
            hi_const=hi_const if has_boxes else None,
            iterations=world.solver.lcp_iterations,
            solver=world.solver.lcp_solver,
            refine_rounds=world.solver.lcp_refine_rounds,
            seed_pgs_sweeps=world.solver.lcp_seed_pgs_sweeps,
            k_active=min(n, max(16, 2 * world.num_dofs + 8)),
        )

    @property
    def num_rows(self) -> int:
        return (
            3 * self.num_contacts
            + len(self.limit_rows)
            + len(self.motor_rows)
            + self.dyn_rows
        )

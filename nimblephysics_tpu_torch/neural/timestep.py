"""The differentiable timestep of one world.

Counterpart of nimblephysics_tpu/neural/timestep.py (the reference's
nimble.timestep: World::step with its BackpropSnapshot gradients). One
step, in the reference's order (World.cpp:221):
  1. smooth forward dynamics and velocity integration -> v_pre;
  2. collision at the pre-step q_t, the boxed LCP on v_pre -> impulses;
  3. v_{t+1} = v_pre + M^-1 J^T z;
  4. q_{t+1} integrated from the pre-step velocity v_t (the parallel
     velocity and position update, World.cpp:307-324).
torch autograd through `step` is the backward pass through contact,
friction, bouncing and joint limits: the smooth parts differentiate
exactly and the LCP through its pinned active-set solve
(constraint/lcp.py). Each skeleton's mass matrix is factored once
(M = L L^T) and L serves the smooth solve, F = J L^-T and the impulse
update.

Device rule: Engine(world) with no device means "cuda" and raises where
there is no GPU; device="cpu" asks for the CPU. `timestep` steps on the
device and in the dtype of its state and raises on a mixed device; it
never copies a tensor from one device to another. No TPU kernel is on
this path: the JAX package's single-world LCP runs its seed as plain
differentiable arithmetic, and so does this one.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from nimblephysics_tpu_torch.collision.collider import Collider, Contacts
from nimblephysics_tpu_torch.constraint.assembly import ConstraintAssembler, tangent_basis
from nimblephysics_tpu_torch.constraint.lcp import boxed_lcp
from nimblephysics_tpu_torch.dynamics.skeleton import (
    full_kinematics,
    mass_and_bias_fused,
    passive_forces,
)
from nimblephysics_tpu_torch.simulation.world import World, world_integrate_positions


class StepResult(NamedTuple):
    q: torch.Tensor
    v: torch.Tensor
    v_pre: torch.Tensor  # the pre-constraint velocity
    impulses: torch.Tensor  # the LCP solution z, (n_rows,)
    contact_points: torch.Tensor  # (C, 3)
    contact_normals: torch.Tensor  # (C, 3)
    contact_depths: torch.Tensor  # (C,)
    contact_forces: torch.Tensor  # (C, 3) world-frame force on body A


class LcpProblem(NamedTuple):
    """The LCP one step solves, and what the step needs around it."""

    F: torch.Tensor  # (n, nv) = J L^-T
    b: torch.Tensor  # (n,)
    mu: torch.Tensor  # (n,)
    v_pre: torch.Tensor  # (nv,)
    Ls: Dict[int, torch.Tensor]  # each skeleton's Cholesky factor of M
    contacts: Optional[Contacts]  # None without rows


class Engine:
    """The static step plan of one World (collider and row plan) on one
    device and dtype; `step` is a pure function of its tensors."""

    def __init__(self, world: World, device=None, dtype: torch.dtype = torch.float64):
        from nimblephysics_tpu_torch.batched.engine import _resolve_device

        self.world = world
        self.device = _resolve_device(device)
        self.dtype = dtype
        self.collider = Collider(world)
        self.collider.check_uncapped()
        self.assembler = ConstraintAssembler(world, self.collider)
        force_mask = np.ones(world.num_dofs)
        for d, act in world.actuator_types.items():
            if act["kind"] != "force":
                force_mask[d] = 0.0
        t = dict(dtype=dtype, device=self.device)
        self._c = SimpleNamespace(
            gravity=torch.as_tensor(world.gravity, **t),
            force_mask=(torch.as_tensor(force_mask, **t) if world.actuator_types else None),
        )

    @property
    def num_constraint_rows(self) -> int:
        return self.assembler.num_rows

    def _check(self, name, x, size):
        if x.device != self.device or x.dtype != self.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; this engine takes "
                             f"{self.dtype} on {self.device}")
        if tuple(x.shape) != (size,):
            raise ValueError(f"{name} must be ({size},), got {tuple(x.shape)}")

    def _split_body_params(self, body_params):
        """World-level (NB, ...) body parameters -> one dict per skeleton."""
        if body_params is None:
            return [None] * len(self.world.skeletons)
        bp = {}
        for key, val in body_params.items():
            if val is None:
                continue
            if torch.is_tensor(val) and val.device != self.device:
                raise ValueError(f"body_params[{key!r}] is on {val.device}; this engine "
                                 f"takes {self.device}")
            bp[key] = torch.as_tensor(val, dtype=self.dtype, device=self.device)
        offs = self.world.body_offsets()
        return [{k: x[s : s + sk.num_bodies] for k, x in bp.items()}
                for s, sk in zip(offs, self.world.skeletons)]

    def _chol_and_bias(self, q, v, body_params=None):
        """Each skeleton's Cholesky factor of M, the bias C (nv,) and the
        world kinematics {"T_wb" (NB, 4, 4), "J_world" (NB, 6, nv)}, from
        one kinematics pass per skeleton."""
        w = self.world
        nv = w.num_dofs
        bp = self._split_body_params(body_params)
        Ls: Dict[int, torch.Tensor] = {}
        C, T, Jw = [], [], []
        for k, (sk, (s, e)) in enumerate(zip(w.skeletons, w.dof_slices())):
            if sk.num_dofs == 0:
                T.append(full_kinematics(sk, q[s:e])["T_wb"])
                Jw.append(q.new_zeros(sk.num_bodies, 6, nv))
                continue
            M, Ck, kin = mass_and_bias_fused(sk, q[s:e], v[s:e], gravity=self._c.gravity,
                                             body_params=bp[k])
            Ls[k] = torch.linalg.cholesky_ex(M)[0]
            C.append(Ck)
            T.append(kin["T_wb"])
            Jk = kin["J_world"]
            Jw.append(torch.cat([Jk.new_zeros(sk.num_bodies, 6, s), Jk,
                                 Jk.new_zeros(sk.num_bodies, 6, nv - e)], dim=2))
        bias = torch.cat(C) if C else q.new_zeros(0)
        return Ls, bias, {"T_wb": torch.cat(T), "J_world": torch.cat(Jw)}

    def _blocks(self, Ls):
        for k, (s, e) in enumerate(self.world.dof_slices()):
            if k in Ls:
                yield Ls[k], s, e

    def _minv_apply(self, Ls, x):
        """M^-1 x through the skeletons' Cholesky factors."""
        out = []
        for L, s, e in self._blocks(Ls):
            y = torch.linalg.solve_triangular(L, x[s:e, None], upper=False)
            out.append(torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0])
        return torch.cat(out) if out else x

    def _passive(self, q, v):
        w = self.world
        return torch.cat([passive_forces(sk, q[s:e], v[s:e])
                          for sk, (s, e) in zip(w.skeletons, w.dof_slices())])

    def lcp_problem(self, q, v, control, body_params=None) -> "LcpProblem":
        """Everything of a step before the LCP solve: the smooth dynamics
        (v_pre), collision at q and the rows, as F = J L^-T (n, nv), b and
        mu (n,). With no rows, no collision runs and F, b, mu are empty."""
        w = self.world
        # 1. Smooth dynamics -> the pre-constraint velocity.
        Ls, bias, kin = self._chol_and_bias(q, v, body_params)
        # Servo, mimic and locked dofs read their control as a command.
        tau = control if self._c.force_mask is None else control * self._c.force_mask
        v_pre = v + w.time_step * self._minv_apply(Ls, tau + self._passive(q, v) - bias)
        if self.assembler.num_rows == 0:
            empty = q.new_zeros(0)
            return LcpProblem(q.new_zeros(0, w.num_dofs), empty, empty, v_pre, Ls, None)
        # 2. Collision at the pre-step q; the rows on v_pre, and the
        # factored form F = J L^-T of the LCP's Delassus operator.
        contacts = self.collider.collide(q, T_wb=kin["T_wb"])
        Jm, b, mu, _ = self.assembler.assemble(q, v_pre, contacts, kin["J_world"],
                                               T_wb=kin["T_wb"], control=control)
        F = torch.cat([torch.linalg.solve_triangular(L, Jm[:, s:e].T, upper=False).T
                       for L, s, e in self._blocks(Ls)], dim=1)
        return LcpProblem(F, b, mu, v_pre, Ls, contacts)

    def step(self, q: torch.Tensor, v: torch.Tensor, control: torch.Tensor,
             z_warm: Optional[torch.Tensor] = None,
             body_params: Optional[Dict] = None) -> StepResult:
        """One physics step, differentiable in (q, v, control) and in the
        tensors of `body_params` ({"masses" (NB,), "coms" (NB, 3),
        "inertias" (NB, 3, 3), "scales" (NB, 3)}, any subset; the
        reference's WithRespectToMass / GROUP_COMS / GROUP_INERTIAS /
        GROUP_SCALES). `control` is a full generalized-force vector (see
        World.action_to_forces); z_warm (n_rows,) warm-starts the LCP."""
        w = self.world
        dt = w.time_step
        nv, nrows = w.num_dofs, self.assembler.num_rows
        for name, x in (("q", q), ("v", v), ("control", control)):
            self._check(name, x, nv)
        if z_warm is None:
            z_warm = q.new_zeros(nrows)
        self._check("z_warm", z_warm, nrows)
        prob = self.lcp_problem(q, v, control, body_params)
        if nrows > 0:
            cfg = w.solver
            z = boxed_lcp(self.assembler.meta, prob.F, prob.b, prob.mu, z_warm, cfm=cfg.cfm,
                          fallback_cfm=cfg.fallback_cfm)
            # 3. The impulses' velocity change M^-1 J^T z = L^-T (F^T z).
            u = prob.F.T @ z
            v_next = prob.v_pre + torch.cat([
                torch.linalg.solve_triangular(L.T, u[s:e, None], upper=True)[:, 0]
                for L, s, e in self._blocks(prob.Ls)])
            c = prob.contacts
            cp, cn, cd = c.point, c.normal, c.depth
            C = self.collider.num_contacts
            if C > 0:
                t1, t2 = tangent_basis(cn)
                zc = z[: 3 * C].reshape(C, 3)
                f_world = (cn * zc[:, 0:1] + t1 * zc[:, 1:2] + t2 * zc[:, 2:3]) / dt
            else:
                f_world = q.new_zeros(0, 3)
        else:
            v_next = prob.v_pre
            z = q.new_zeros(0)
            cp = cn = f_world = q.new_zeros(0, 3)
            cd = q.new_zeros(0)

        # 4. Position integration from the pre-step velocity.
        v_for_pos = v if w.parallel_velocity_and_position_updates else v_next
        q_next = world_integrate_positions(w, q, v_for_pos, dt)
        return StepResult(q=q_next, v=v_next, v_pre=prob.v_pre, impulses=z,
                          contact_points=cp, contact_normals=cn, contact_depths=cd,
                          contact_forces=f_world)

    def state_step(self, state: torch.Tensor, action: torch.Tensor,
                   masses: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The RL step on [positions; velocities] (2 nv,) and an action
        (action_size,) (World.hpp:471-523); masses: optional (NB,)."""
        w = self.world
        nv = w.num_dofs
        if state.shape[-1] != 2 * nv:
            raise ValueError(f"state has {state.shape[-1]} entries; world {w.name!r} "
                             f"expects 2*num_dofs = {2 * nv} ([positions; velocities])")
        if action.shape[-1] != w.action_size:
            raise ValueError(f"action has {action.shape[-1]} entries; world {w.name!r} "
                             f"expects action_size = {w.action_size} "
                             "(see World.set_action_space)")
        self._check("action", action, w.action_size)
        res = self.step(state[:nv], state[nv:], w.action_to_forces(action),
                        body_params=None if masses is None else {"masses": masses})
        return torch.cat([res.q, res.v])


def get_engine(world: World, device=None, dtype: torch.dtype = torch.float64) -> Engine:
    """One Engine per (device, dtype), cached on the world (no module-level
    table keyed by id, which would keep every world alive)."""
    from nimblephysics_tpu_torch.batched.engine import _resolve_device

    key = (str(_resolve_device(device)), dtype)
    cache = world.__dict__.setdefault("_engine_cache", {})
    if key not in cache:
        cache[key] = Engine(world, device=key[0], dtype=dtype)
    return cache[key]


def timestep(world: World, state: torch.Tensor, action: torch.Tensor,
             masses: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nimble.timestep(world, state, action, mass): one differentiable
    step of [positions; velocities] under an action and, optionally,
    per-body masses, on the device and in the dtype of `state`."""
    for name, x in (("action", action), ("masses", masses)):
        if torch.is_tensor(x) and x.device != state.device:
            raise ValueError(f"{name} is on {x.device} and state on {state.device}; "
                             "timestep copies nothing between devices")
    return get_engine(world, device=state.device, dtype=state.dtype).state_step(
        state, action, masses)

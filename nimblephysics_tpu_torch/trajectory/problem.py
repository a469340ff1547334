"""Trajectory optimization problems: single / multiple shooting.

Counterpart of nimblephysics_tpu/trajectory/problem.py. Reference parity:
dart/trajectory (SURVEY.md 2.5): Problem (Problem.hpp:28-418, flattened
variables + constraint dims + rollout cache), SingleShot (cached snapshot
chain), MultiShot (MultiShot.hpp:282-285 knot-consistency constraints;
per-shot computation on cloned worlds, MultiShot.cpp:189-225).

A problem is a function of its flat variable vector x, a tensor on the
device and in the dtype of the problem's single-world Engine (the card
and float64 unless the caller passes device="cpu" or another dtype):
  * SingleShot: x = [start_state?, forces (T * na)]; the rollout is a loop
    of the differentiable timestep, and gradients come from torch
    autograd through it.
  * MultiShot: x = [shot start states, all forces]; the shots, which are
    few, roll out one after another, with knot-consistency equality
    constraints h(x) = 0 between consecutive shots.

The per-step Jacobians A_t = d s_{t+1} / d s_t and B_t = d s_{t+1} / d u_t
of the reference's KnotJacobian scheme come from the BackpropSnapshot of
each step (one batched reverse pass a step), and the shot sensitivities
are their products (`shot_sensitivities`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from nimblephysics_tpu_torch.neural.backprop_snapshot import BackpropSnapshot
from nimblephysics_tpu_torch.neural.timestep import Engine, get_engine
from nimblephysics_tpu_torch.neural.with_respect_to import jacobian_rows
from nimblephysics_tpu_torch.simulation.world import World


class TrajectoryRollout(NamedTuple):
    """Reference parity: trajectory::TrajectoryRollout (poses/vels/forces
    matrices per mapping, TrajectoryRollout.hpp:28-127). `mapped` holds
    per-mapping pos/vel trajectories for every mapping registered on the
    Problem (reference: MappedBackpropSnapshot losses)."""

    poses: torch.Tensor  # (T, nq)
    vels: torch.Tensor  # (T, nv)
    forces: torch.Tensor  # (T, na)
    mapped: dict = {}  # name -> {"pos": (T, d), "vel": (T, d)}

    def to_json(self) -> str:
        import json

        return json.dumps({
            k: getattr(self, k).detach().cpu().numpy().tolist()
            for k in ("poses", "vels", "forces")
        })


# A loss is a callable TrajectoryRollout -> scalar tensor (reference: LossFn
# closures; gradients come from autograd instead of fill_gradients plumbing).
LossFn = Callable[[TrajectoryRollout], torch.Tensor]


def jacobian(f: Callable, x: torch.Tensor) -> torch.Tensor:
    """d f / d x at x, (*f(x).shape, n), from one batched reverse pass over
    the rows of f(x)."""
    x = x.detach().clone().requires_grad_()
    with torch.enable_grad():
        out = f(x)
    if out.numel() == 0:
        return x.new_zeros(*out.shape, *x.shape)
    return jacobian_rows(out, [x])[0]


class Problem:
    """Abstract trajectory NLP over a flat variable vector x.

    Interface (reference Problem.hpp): flatten/unflatten, loss(x),
    constraints h(x) (equalities), bounds, rollout extraction.
    """

    def __init__(self, world: World, loss_fn: LossFn, steps: int, device=None,
                 dtype: torch.dtype = torch.float64):
        self.world = world
        self.engine: Engine = get_engine(world, device, dtype)
        self.device, self.dtype = self.engine.device, dtype
        self.loss_fn = loss_fn
        self.steps = steps
        self.nv = world.num_dofs
        self.na = world.action_size
        # Pinned forces (reference: Problem::pinForce, Problem.hpp:332-339)
        # — fixed control rows the optimizer must not change.
        self._pinned: dict = {}  # t -> (na,) np array
        # Loss mappings (reference: Problem::addMapping + per-mapping
        # TrajectoryRollout matrices): name -> IKMapping/IdentityMapping.
        self.mappings: dict = {}

    def tensor(self, x) -> torch.Tensor:
        """x as a tensor on the problem's device, in its dtype."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def pin_force(self, t: int, value) -> None:
        """Fix the controls at timestep `t` to `value` (excluded from the
        optimization: the rollout overrides that row, so the loss is
        constant in the corresponding variables)."""
        self._pinned[int(t)] = np.asarray(value, dtype=np.float64)

    def get_pinned_force(self, t: int):
        return self._pinned.get(int(t))

    def add_mapping(self, name: str, mapping) -> None:
        """Register a loss-space mapping; rollouts then carry
        rollout.mapped[name] = {"pos": (T, d), "vel": (T, d)}."""
        self.mappings[name] = mapping

    def _apply_pins(self, forces: torch.Tensor) -> torch.Tensor:
        """Override pinned rows of a (T, na) force matrix (out of place: the
        overridden variables get no gradient)."""
        if not self._pinned:
            return forces
        rows = sorted(self._pinned)
        vals = torch.stack([torch.as_tensor(self._pinned[t], dtype=forces.dtype,
                                            device=forces.device) for t in rows])
        idx = torch.as_tensor(rows, device=forces.device)
        return forces.index_put((idx,), vals)

    def _force_mask(self) -> torch.Tensor:
        """(steps,) 0 on pinned steps, 1 elsewhere."""
        mask = np.ones(self.steps)
        for t in self._pinned:
            mask[t] = 0.0
        return self.tensor(mask)

    def _mapped(self, poses: torch.Tensor, vels: torch.Tensor) -> dict:
        out = {}
        for name, m in self.mappings.items():
            out[name] = {
                "pos": torch.stack([m.map_pos(q) for q in poses]),
                "vel": torch.stack([m.map_vel(q, v) for q, v in zip(poses, vels)]),
            }
        return out

    @property
    def num_variables(self) -> int:
        raise NotImplementedError

    @property
    def num_constraints(self) -> int:
        return 0

    def loss(self, x: torch.Tensor) -> torch.Tensor:
        return self.loss_fn(self.rollout(x))

    def constraints(self, x: torch.Tensor) -> torch.Tensor:
        return x.new_zeros(0)

    def loss_and_constraints(self, x: torch.Tensor):
        """(loss(x), constraints(x)); MultiShot takes both from one
        rollout."""
        return self.loss(x), self.constraints(x)

    def rollout(self, x: torch.Tensor) -> TrajectoryRollout:
        raise NotImplementedError

    def initial_guess(self, start_state) -> torch.Tensor:
        raise NotImplementedError

    # -- shared rollout machinery -----------------------------------------

    def _states(self, state0: torch.Tensor, forces: torch.Tensor) -> torch.Tensor:
        """(2nv,), (T, na) -> the (T, 2nv) states AFTER each step."""
        s, out = state0, []
        for u in forces:
            s = self.engine.state_step(s, u)
            out.append(s)
        return torch.stack(out)

    def _scan_rollout(self, state0: torch.Tensor, forces: torch.Tensor):
        """(2nv,), (T, na) -> poses (T, nq), vels (T, nv) AFTER each step."""
        states = self._states(state0, forces)
        return states[:, : self.nv], states[:, self.nv :]


class SingleShot(Problem):
    """One rollout from a (fixed or tuned) start state.

    Reference parity: trajectory::SingleShot (SingleShot.hpp:115 cached
    snapshot chain; backpropJacobianOfFinalState:92 — here the reverse
    pass by rows of `final_state`).
    """

    def __init__(
        self,
        world: World,
        loss_fn: LossFn,
        steps: int,
        start_state=None,
        tune_starting_state: bool = False,
        device=None,
        dtype: torch.dtype = torch.float64,
    ):
        super().__init__(world, loss_fn, steps, device, dtype)
        self.tune_starting_state = tune_starting_state
        self.start_state = self.tensor(
            np.zeros(2 * self.nv) if start_state is None else start_state)

    @property
    def num_variables(self) -> int:
        n = self.steps * self.na
        if self.tune_starting_state:
            n += 2 * self.nv
        return n

    def _split(self, x):
        if self.tune_starting_state:
            s0 = x[: 2 * self.nv]
            forces = x[2 * self.nv :].reshape(self.steps, self.na)
        else:
            s0 = self.start_state.to(x.dtype)
            forces = x.reshape(self.steps, self.na)
        return s0, forces

    def rollout(self, x: torch.Tensor) -> TrajectoryRollout:
        s0, forces = self._split(x)
        forces = self._apply_pins(forces)
        poses, vels = self._scan_rollout(s0, forces)
        return TrajectoryRollout(poses, vels, forces, self._mapped(poses, vels))

    def final_state(self, x: torch.Tensor) -> torch.Tensor:
        r = self.rollout(x)
        return torch.cat([r.poses[-1], r.vels[-1]])

    def backprop_jacobian_of_final_state(self, x: torch.Tensor) -> torch.Tensor:
        """Reference parity: SingleShot::backpropJacobianOfFinalState."""
        return jacobian(self.final_state, x)

    def initial_guess(self, start_state) -> torch.Tensor:
        start_state = self.tensor(start_state)
        forces = start_state.new_zeros(self.steps * self.na)
        if self.tune_starting_state:
            return torch.cat([start_state, forces])
        self.start_state = start_state
        return forces


class MultiShot(Problem):
    """Multiple shooting: shots + knot-consistency constraints.

    Reference parity: trajectory::MultiShot — knot variables
    (MultiShot.hpp:282-285) and per-shot rollouts (the reference's
    mParallelWorlds thread pool, MultiShot.cpp:66-69; the JAX package
    vmaps the shots). Here the shots run one after another.
    """

    def __init__(
        self,
        world: World,
        loss_fn: LossFn,
        steps: int,
        shot_length: int,
        start_state=None,
        device=None,
        dtype: torch.dtype = torch.float64,
    ):
        super().__init__(world, loss_fn, steps, device, dtype)
        assert steps % shot_length == 0, "steps must divide into shots"
        self.shot_length = shot_length
        self.num_shots = steps // shot_length
        self.start_state = self.tensor(
            np.zeros(2 * self.nv) if start_state is None else start_state)
        # One-entry caches of the last x's shot sensitivities and of its
        # rollout without a graph: the constraint and terminal Jacobians of
        # one iterate, and its residuals and constraints, share them.
        self._sens = None
        self._roll = None

    @property
    def num_variables(self) -> int:
        # Knot start states for shots 1..S-1 (shot 0 starts at the fixed
        # start state) + all forces.
        return (self.num_shots - 1) * 2 * self.nv + self.steps * self.na

    @property
    def num_constraints(self) -> int:
        return (self.num_shots - 1) * 2 * self.nv

    def _split(self, x):
        nknot = (self.num_shots - 1) * 2 * self.nv
        knots = x[:nknot].reshape(self.num_shots - 1, 2 * self.nv)
        forces = x[nknot:].reshape(self.num_shots, self.shot_length, self.na)
        starts = torch.cat([self.start_state.to(x.dtype)[None], knots], dim=0)
        return starts, forces

    def _pinned_forces(self, forces):
        """(S, L, na) forces with the pinned rows overridden."""
        if not self._pinned:
            return forces
        flat = self._apply_pins(forces.reshape(self.steps, self.na))
        return flat.reshape(self.num_shots, self.shot_length, self.na)

    def _key(self, x):
        return (x.detach().clone(), self.start_state.clone(),
                sorted((t, v.tobytes()) for t, v in self._pinned.items()))

    def _shot_states(self, x):
        """All shots: (S, L, 2nv) post-step states, and the forces."""
        key = None
        if not (torch.is_grad_enabled() and x.requires_grad):
            key = self._key(x)
            if self._roll is not None and _same_key(self._roll[0], key):
                return self._roll[1]
        starts, forces = self._split(x)
        forces = self._pinned_forces(forces)
        states = torch.stack([self._states(s0, us) for s0, us in zip(starts, forces)])
        if key is not None:
            self._roll = (key, (states, forces))
        return states, forces

    def _rollout_of(self, states, forces) -> TrajectoryRollout:
        flat = states.reshape(self.steps, 2 * self.nv)
        poses, vels = flat[:, : self.nv], flat[:, self.nv :]
        return TrajectoryRollout(poses, vels, forces.reshape(self.steps, self.na),
                                 self._mapped(poses, vels))

    def _knots(self, x, states):
        starts, _ = self._split(x)
        ends = states[:-1, -1, :]  # (S-1, 2nv)
        return (ends - starts[1:]).reshape(-1)

    def rollout(self, x: torch.Tensor) -> TrajectoryRollout:
        return self._rollout_of(*self._shot_states(x))

    def constraints(self, x: torch.Tensor) -> torch.Tensor:
        """Knot mismatches h(x) = end(shot_i) - start(shot_{i+1}) = 0
        (reference: MultiShot::computeConstraints, MultiShot.cpp:183)."""
        return self._knots(x, self._shot_states(x)[0])

    def loss_and_constraints(self, x: torch.Tensor):
        states, forces = self._shot_states(x)
        return self.loss_fn(self._rollout_of(states, forces)), self._knots(x, states)

    def constraint_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        """Reference parity: MultiShot::backpropJacobian (cpp:475), by one
        batched reverse pass over the rows of h through the whole rollout."""
        return jacobian(self.constraints, x)

    # -- per-step Jacobians (the reference's KnotJacobian scheme) -----------

    def _step_jacobians(self, x):
        """Per-step state-transition Jacobians A_t = d s_{t+1} / d s_t and
        B_t = d s_{t+1} / d u_t for every shot, plus the post-step states:
        each step's BackpropSnapshot (its state and action Jacobians, one
        batched reverse pass), the reference's KnotJacobian accumulation
        (SingleShot::backpropJacobianOfFinalState, MultiShot::
        backpropJacobian, MultiShot.cpp:475-584).

        Returns (A (S, L, 2nv, 2nv), B (S, L, 2nv, na), states
        (S, L, 2nv)).
        """
        w, nv = self.world, self.nv
        starts, forces = self._split(x.detach())
        forces = self._pinned_forces(forces)
        A, B, states = [], [], []
        for s, us in zip(starts, forces):
            for u in us:
                snap = BackpropSnapshot(w, s[:nv], s[nv:], w.action_to_forces(u))
                A.append(snap.get_state_jacobian())
                B.append(snap.get_action_jacobian())
                s = torch.cat([snap.q_next, snap.v_next])
                states.append(s)
        S, L, ns = self.num_shots, self.shot_length, 2 * nv
        A = torch.stack(A).reshape(S, L, ns, ns)
        B = torch.stack(B).reshape(S, L, ns, self.na)
        states = torch.stack(states).reshape(S, L, ns)
        if self._pinned:
            # Pinned force rows are overridden by constants: their columns
            # of the Jacobian wrt the OPTIMIZATION variables are zero.
            B = B * self._force_mask().reshape(S, L, 1, 1)
        return A, B, states

    @staticmethod
    def _accumulate_shot(A, B):
        """For one shot: E = d end / d start = A_{L-1} ... A_0 and
        F_t = d end / d u_t = (A_{L-1} ... A_{t+1}) B_t, by one reverse
        pass of matrix products."""
        H = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        F = [None] * A.shape[0]
        for t in reversed(range(A.shape[0])):
            F[t] = H @ B[t]
            H = H @ A[t]
        return H, torch.stack(F)

    def shot_sensitivities(self, x):
        """(E (S, 2nv, 2nv), F (S, L, 2nv, na), states): per-shot
        end-state sensitivities wrt the shot start and each force row.
        The last x's are kept."""
        key = self._key(x)
        if self._sens is not None and _same_key(self._sens[0], key):
            return self._sens[1]
        A, B, states = self._step_jacobians(x)
        EF = [self._accumulate_shot(a, b) for a, b in zip(A, B)]
        out = (torch.stack([e for e, _ in EF]), torch.stack([f for _, f in EF]), states)
        self._sens = (key, out)
        return out

    def constraint_jacobian_scan(self, x: torch.Tensor) -> torch.Tensor:
        """d h / d x assembled from the per-step Jacobians — the values of
        `constraint_jacobian` (tested), with one reverse pass a step instead
        of one through the whole rollout."""
        E, F, _ = self.shot_sensitivities(x)
        S, L = self.num_shots, self.shot_length
        ns = 2 * self.nv
        nknot = (S - 1) * ns
        J = x.new_zeros(self.num_constraints, self.num_variables)
        eye = torch.eye(ns, dtype=x.dtype, device=x.device)
        for i in range(S - 1):
            r = i * ns
            # h_i = end(shot_i) - knot_i; start of shot_i is knot_{i-1}
            # (shot 0 starts at the fixed start state).
            if i > 0:
                J[r : r + ns, (i - 1) * ns : i * ns] = E[i]
            J[r : r + ns, i * ns : (i + 1) * ns] = -eye
            fcols = F[i].permute(1, 0, 2).reshape(ns, L * self.na)
            c0 = nknot + i * L * self.na
            J[r : r + ns, c0 : c0 + L * self.na] = fcols
        return J

    def final_state_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        """d (end state of the LAST shot) / d x, (2nv, n) — the terminal
        sensitivity used by TerminalResiduals (reference:
        backpropJacobianOfFinalState)."""
        E, F, _ = self.shot_sensitivities(x)
        S, L = self.num_shots, self.shot_length
        ns = 2 * self.nv
        nknot = (S - 1) * ns
        J = x.new_zeros(ns, self.num_variables)
        if S > 1:
            J[:, (S - 2) * ns : (S - 1) * ns] = E[-1]
        fcols = F[-1].permute(1, 0, 2).reshape(ns, L * self.na)
        c0 = nknot + (S - 1) * L * self.na
        J[:, c0 : c0 + L * self.na] = fcols
        return J

    def initial_guess(self, start_state) -> torch.Tensor:
        self.start_state = start_state = self.tensor(start_state)
        knots = start_state[None].expand(self.num_shots - 1, -1).reshape(-1)
        forces = start_state.new_zeros(self.steps * self.na)
        return torch.cat([knots, forces])


def _same_key(a, b) -> bool:
    return (a[0].shape == b[0].shape and torch.equal(a[0], b[0])
            and torch.equal(a[1], b[1]) and a[2] == b[2])


class TerminalResiduals:
    """Residuals that touch the rollout only through the FINAL state and
    the force matrix — the common shooting-objective class (reach target
    + terminal velocity + effort, e.g. test_AtlasTrajectory.cpp's loss).

    Callable as `residuals(x)` for GaussNewtonOptimizer, and provides an
    analytic `jacobian(x)` composed from the problem's per-step terminal
    sensitivity (MultiShot.final_state_jacobian) and a jacrev of the
    small function `fn`, so the optimizer never reverse-differentiates a
    whole rollout."""

    def __init__(self, problem: MultiShot, fn):
        """fn(final_state (2nv,), forces (T, na)) -> residual vector."""
        self.problem = problem
        self.fn = fn

    def _final_and_forces(self, x):
        p = self.problem
        states, forces = p._shot_states(x)
        return states[-1, -1], forces.reshape(p.steps, p.na)

    def __call__(self, x):
        final, forces = self._final_and_forces(x)
        return self.fn(final, forces)

    def jacobian(self, x):
        p = self.problem
        _, _, states = p.shot_sensitivities(x)
        _, forces = p._split(x.detach())
        forces = p._pinned_forces(forces).reshape(p.steps, p.na)
        dr_de, dr_df = torch.func.jacrev(self.fn, argnums=(0, 1))(states[-1, -1], forces)
        J = dr_de @ p.final_state_jacobian(x)
        nknot = (p.num_shots - 1) * 2 * p.nv
        nr = dr_de.shape[0]
        dr_df = dr_df.reshape(nr, p.steps * p.na)
        if p._pinned:
            dr_df = dr_df * torch.repeat_interleave(p._force_mask(), p.na)[None, :]
        J[:, nknot:] += dr_df
        return J

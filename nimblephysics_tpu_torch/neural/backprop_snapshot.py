"""BackpropSnapshot: the timestep Jacobians and reverse-mode backprop.

Counterpart of nimblephysics_tpu/neural/backprop_snapshot.py. Reference
parity: dart/neural/BackpropSnapshot.hpp/.cpp — the object returned by
neural::forwardPass(world) carrying pos-pos, pos-vel, vel-pos, vel-vel,
force-vel and mass-vel Jacobians plus `backprop`/`backpropState`.

The snapshot runs one cold-started step of neural/timestep.py's Engine
with its inputs as autograd leaves and keeps that step's graph. Every
Jacobian then comes from one batched reverse pass over the rows of
[q'; v'] (with_respect_to.jacobian_rows): all the blocks at once, in
(q, v, control[, masses][, scales]), cached detached. `backprop` is one
reverse pass of the same graph with the loss's gradient (a VJP; no dense
Jacobian), as the reference's backprop() does with hand-written J^T
products (BackpropSnapshot.cpp:121-180). The snapshot lives on the device
and in the dtype of its q; inputs on another device raise.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from nimblephysics_tpu_torch.neural.timestep import StepResult, get_engine
from nimblephysics_tpu_torch.neural.with_respect_to import jacobian_rows
from nimblephysics_tpu_torch.simulation.world import World


class LossGradient(NamedTuple):
    """Reference parity: neural::LossGradient (lossWrtPosition/Velocity/
    Torque) and LossGradientHighLevelAPI (lossWrtState/Action/Mass)."""

    loss_wrt_position: torch.Tensor
    loss_wrt_velocity: torch.Tensor
    loss_wrt_torque: torch.Tensor
    loss_wrt_mass: Optional[torch.Tensor] = None


# Cache key -> (input, rows of [q'; v']): "posvel" is d v' / d q.
_BLOCKS = {
    "pospos": ("q", "pos"), "posvel": ("q", "vel"),
    "velpos": ("v", "pos"), "velvel": ("v", "vel"),
    "forcepos": ("control", "pos"), "forcevel": ("control", "vel"),
    "masspos": ("masses", "pos"), "massvel": ("masses", "vel"),
    "scalepos": ("scales", "pos"), "scalevel": ("scales", "vel"),
}


def _same_device(like: torch.Tensor, **named):
    for name, x in named.items():
        if torch.is_tensor(x) and x.device != like.device:
            raise ValueError(f"{name} is on {x.device} and the state on {like.device}; "
                             "the snapshot copies nothing between devices")


class BackpropSnapshot:
    """Snapshot of one differentiable step at (q, v, control[, masses]).

    All Jacobians are evaluated at the snapshot point and cached
    (reference: the mCached* members of BackpropSnapshot).
    """

    def __init__(
        self,
        world: World,
        q: torch.Tensor,
        v: torch.Tensor,
        control: torch.Tensor,
        masses: Optional[torch.Tensor] = None,
        scales: Optional[torch.Tensor] = None,
        clip_loss_gradients_to_bounds: bool = False,
    ):
        _same_device(q, v=v, control=control, masses=masses, scales=scales)
        self.world = world
        self.engine = get_engine(world, device=q.device, dtype=q.dtype)
        self.q, self.v, self.control = (x.detach() for x in (q, v, control))
        self.masses = None if masses is None else masses.detach()
        self.scales = None if scales is None else scales.detach()
        self.clip = clip_loss_gradients_to_bounds
        self._cache: Dict[str, torch.Tensor] = {}

        # The step's inputs as leaves, and its graph, kept for the
        # Jacobians and backprop. Cold start, as the reference snapshot.
        named = dict(q=self.q, v=self.v, control=self.control, masses=self.masses,
                     scales=self.scales)
        self._leaves = {k: x.clone().requires_grad_() for k, x in named.items()
                        if x is not None}
        with torch.enable_grad():
            res = self.engine.step(self._leaves["q"], self._leaves["v"],
                                   self._leaves["control"],
                                   body_params=self._bp(self._leaves.get("masses"),
                                                        self._leaves.get("scales")))
        self._out = torch.cat([res.q, res.v])
        self.result = StepResult(*(x.detach() for x in res))
        self.q_next, self.v_next = self.result.q, self.result.v
        # Reference parity: pre-constraint velocity snapshot
        # (mPreConstraintVelocities).
        self.pre_constraint_velocity = self.result.v_pre

    @staticmethod
    def _bp(masses, scales):
        bp = {}
        if masses is not None:
            bp["masses"] = masses
        if scales is not None:
            bp["scales"] = scales
        return bp or None

    def _sync(self):
        if self.q.device.type == "cuda":
            torch.cuda.synchronize(self.q.device)

    # -- the Jacobian blocks, from one batched reverse pass ------------------

    def _jacobians(self):
        """Fill the cache with every block: the state Jacobian (2nv, 2nv),
        d[q'; v']/d control (2nv, nv) and the _BLOCKS."""
        names = list(self._leaves)
        J = dict(zip(names, jacobian_rows(self._out, [self._leaves[k] for k in names],
                                          retain_graph=True)))
        nv = self.world.num_dofs
        rows = {"pos": slice(0, nv), "vel": slice(nv, 2 * nv)}
        self._cache["state"] = torch.cat([J["q"], J["v"]], dim=1)
        self._cache["force"] = J["control"]
        for key, (x, out) in _BLOCKS.items():
            if x in J:
                self._cache[key] = J[x][rows[out]]

    def _jac(self, key: str) -> torch.Tensor:
        if key.startswith("mass") and self.masses is None:
            raise ValueError("mass Jacobians require timestep masses "
                             "(pass masses= to forward_pass)")
        if key.startswith("scale") and self.scales is None:
            raise ValueError("scale Jacobians require body scales "
                             "(pass scales= to forward_pass)")
        if key not in self._cache:
            self._jacobians()
        return self._cache[key]

    # -- the six Jacobians (reference: BackpropSnapshot.hpp:215-255) --------

    def get_pos_pos_jacobian(self) -> torch.Tensor:
        return self._jac("pospos")

    def get_pos_vel_jacobian(self) -> torch.Tensor:
        return self._jac("posvel")

    def get_vel_pos_jacobian(self) -> torch.Tensor:
        return self._jac("velpos")

    def get_vel_vel_jacobian(self) -> torch.Tensor:
        return self._jac("velvel")

    def get_force_vel_jacobian(self) -> torch.Tensor:
        return self._jac("forcevel")

    def get_force_pos_jacobian(self) -> torch.Tensor:
        return self._jac("forcepos")

    def get_mass_vel_jacobian(self) -> torch.Tensor:
        return self._jac("massvel")

    # GROUP_SCALES differentiation (reference: WithRespectTo.hpp:62-75,
    # Skeleton body-scaling groups, Skeleton.hpp:993-1031). Output shape
    # (nv, nb, 3): sensitivity to each body's per-axis dimension scale.
    def get_scale_vel_jacobian(self) -> torch.Tensor:
        return self._jac("scalevel")

    def get_scale_pos_jacobian(self) -> torch.Tensor:
        return self._jac("scalepos")

    # -- RL-space Jacobians (reference: BackpropSnapshot.hpp:110-114) -------

    def get_state_jacobian(self) -> torch.Tensor:
        """d(next_state)/d(state), (2nv, 2nv).

        Honors the world's gradient debug modes (reference:
        World::setUseFDOverride / setSlowDebugResultsAgainstFD,
        World.hpp:700-713): FD override returns the finite-difference
        Jacobian; slow-debug computes both and raises with a repro when
        they diverge beyond world.fd_debug_tolerance."""
        t = dict(dtype=self.q.dtype, device=self.q.device)
        if self.world.use_fd_override:
            return torch.as_tensor(self.finite_difference_state_jacobian(), **t)
        J = self._jac("state")
        if self.world.slow_debug_results_against_fd:
            fd = torch.as_tensor(self.finite_difference_state_jacobian(), **t)
            err = float((J - fd).abs().max())
            if err > self.world.fd_debug_tolerance:
                raise AssertionError(
                    "[slowDebugResultsAgainstFD] analytical state Jacobian "
                    f"diverges from finite differences by {err:.3e} "
                    f"(tolerance {self.world.fd_debug_tolerance:.1e}).\n"
                    "Repro:\n"
                    f"  q = {self.q.tolist()}\n"
                    f"  v = {self.v.tolist()}\n"
                    f"  control = {self.control.tolist()}\n"
                    f"  world = {self.world!r}"
                )
        return J

    def get_action_jacobian(self) -> torch.Tensor:
        """d(next_state)/d(action), (2nv, na), at the action
        forces_to_action(control): the columns of d[q'; v']/d control on
        the action space, from a step at that action's forces where the
        control has forces outside it."""
        if "action" not in self._cache:
            w = self.world
            idx = torch.as_tensor(w.action_indices.astype(np.int64), device=self.q.device)
            u0 = w.action_to_forces(w.forces_to_action(self.control))
            if torch.equal(u0, self.control):
                J = self._jac("force")
            else:
                J = BackpropSnapshot(w, self.q, self.v, u0, self.masses,
                                     self.scales)._jac("force")
            self._cache["action"] = J[:, idx]
        return self._cache["action"]

    # -- reverse-mode backprop (reference: backprop(), cpp:121) -------------

    def backprop(
        self,
        loss_wrt_next_position: torch.Tensor,
        loss_wrt_next_velocity: torch.Tensor,
    ) -> LossGradient:
        """One reverse pass: J^T products (no dense Jacobians)."""
        _same_device(self.q, loss_wrt_next_position=loss_wrt_next_position,
                     loss_wrt_next_velocity=loss_wrt_next_velocity)
        names = ["q", "v", "control"] + (["masses"] if self.masses is not None else [])
        g = torch.cat([loss_wrt_next_position, loss_wrt_next_velocity])
        grads = torch.autograd.grad(self._out, [self._leaves[k] for k in names], g,
                                    retain_graph=True, allow_unused=True)
        gq, gv, gu, *gm = [torch.zeros_like(self._leaves[k]) if x is None else x
                           for k, x in zip(names, grads)]
        if self.clip:
            gq, gv = self._clip_to_bounds(gq, gv)
        return LossGradient(gq, gv, gu, gm[0] if gm else None)

    def backprop_state(self, loss_wrt_next_state: torch.Tensor):
        """Reference parity: backpropState (BackpropSnapshot.hpp:53) —
        returns (lossWrtState, lossWrtAction, lossWrtMass or None)."""
        nv = self.world.num_dofs
        g = self.backprop(loss_wrt_next_state[:nv], loss_wrt_next_state[nv:])
        loss_wrt_state = torch.cat([g.loss_wrt_position, g.loss_wrt_velocity])
        loss_wrt_action = self.world.forces_to_action(g.loss_wrt_torque)
        return loss_wrt_state, loss_wrt_action, g.loss_wrt_mass

    def _clip_to_bounds(self, gq, gv):
        """Reference parity: clipLossGradientsToBounds
        (BackpropSnapshot.hpp:61) — zero the gradient where the state sits
        at a position/velocity bound and the gradient pushes outward."""
        w = self.world
        t = dict(dtype=gq.dtype, device=gq.device)
        lo = torch.as_tensor(w.position_lower_limits(), **t)
        hi = torch.as_tensor(w.position_upper_limits(), **t)
        at_lo = (self.q <= lo) & (gq > 0)
        at_hi = (self.q >= hi) & (gq < 0)
        gq = torch.where(at_lo | at_hi, torch.zeros_like(gq), gq)
        vlim = torch.as_tensor(w.velocity_limits(), **t)
        at_vlo = (self.v <= -vlim) & (gv > 0)
        at_vhi = (self.v >= vlim) & (gv < 0)
        gv = torch.where(at_vlo | at_vhi, torch.zeros_like(gv), gv)
        return gq, gv

    # -- finite-difference counterparts (reference: hpp:215-255) ------------

    def finite_difference_state_jacobian(self) -> np.ndarray:
        """Ridders FD of the step in [q; v] (numpy on the host; each
        evaluation steps on the snapshot's device)."""
        from nimblephysics_tpu_torch.math import finite_difference_jacobian

        nv = self.world.num_dofs
        t = dict(dtype=self.q.dtype, device=self.q.device)
        bp = self._bp(self.masses, self.scales)

        def f(x):
            s = torch.as_tensor(x, **t)
            with torch.no_grad():
                r = self.engine.step(s[:nv], s[nv:], self.control, body_params=bp)
            return torch.cat([r.q, r.v]).cpu().numpy()

        return finite_difference_jacobian(f, torch.cat([self.q, self.v]).cpu().numpy())

    def benchmark_jacobians(self, samples: int = 10):
        """Reference parity: BackpropSnapshot::benchmarkJacobians
        (cpp:2027) — seconds a call of each Jacobian with the cache
        cleared (each is the one batched reverse pass that fills every
        block), after one warm-up call; on the card the device finishes
        before the clock is read."""
        out = {}
        for name, fn in [
            ("pos-pos", self.get_pos_pos_jacobian),
            ("pos-vel", self.get_pos_vel_jacobian),
            ("vel-pos", self.get_vel_pos_jacobian),
            ("vel-vel", self.get_vel_vel_jacobian),
            ("force-vel", self.get_force_vel_jacobian),
            ("state", self.get_state_jacobian),
            ("action", self.get_action_jacobian),
        ]:
            self._cache.clear()
            fn()
            self._sync()
            t0 = time.perf_counter()
            for _ in range(samples):
                self._cache.clear()
                fn()
            self._sync()
            out[name] = (time.perf_counter() - t0) / samples
        return out


def _state_action(world: World, state, action, device, kw):
    """The state (zeros on `device`, the card unless "cpu", if None) and
    action (zeros if None) of a forward pass; inputs on another device
    than the state raise."""
    from nimblephysics_tpu_torch.batched.engine import _resolve_device

    nv = world.num_dofs
    if state is None:
        state = torch.zeros(2 * nv, dtype=torch.float64, device=_resolve_device(device))
    elif device is not None and torch.device(device) != state.device:
        raise ValueError(f"state is on {state.device}, not on {device}")
    _same_device(state, action=action, **kw)
    if action is None:
        action = state.new_zeros(world.action_size)
    return state, world.action_to_forces(action)


def forward_pass(
    world: World,
    state: Optional[torch.Tensor] = None,
    action: Optional[torch.Tensor] = None,
    masses: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    clip_loss_gradients_to_bounds: bool = False,
    device=None,
) -> BackpropSnapshot:
    """Reference parity: neural::forwardPass(world) (NeuralUtils.cpp:26) —
    run one step and return a BackpropSnapshot, on the device and in the
    dtype of `state`. In this engine the world is static, so the state and
    action are explicit arguments; with no state, the zero state in
    float64 on the card, or on the CPU with device="cpu"."""
    state, control = _state_action(world, state, action, device,
                                   dict(masses=masses, scales=scales))
    nv = world.num_dofs
    return BackpropSnapshot(
        world,
        state[:nv],
        state[nv:],
        control,
        masses=masses,
        scales=scales,
        clip_loss_gradients_to_bounds=clip_loss_gradients_to_bounds,
    )


class MappedBackpropSnapshot(BackpropSnapshot):
    """BackpropSnapshot with losses expressed in mapped spaces.

    Reference parity: neural::MappedBackpropSnapshot
    (MappedBackpropSnapshot.hpp:78) — gradients arrive in one or more
    Mapping spaces (e.g. body-space positions from an IKMapping) and are
    pulled back through the mapping Jacobians at the post-step state
    before the regular world-space backprop.
    """

    def __init__(self, world, q, v, control, mappings, **kw):
        super().__init__(world, q, v, control, **kw)
        self.mappings = dict(mappings)  # name -> Mapping

    def map_post_step(self, name: str):
        """Mapped positions/velocities of the post-step state."""
        m = self.mappings[name]
        return m.map_pos(self.q_next), m.map_vel(self.q_next, self.v_next)

    def backprop_mapped(self, name: str, loss_wrt_mapped_pos,
                        loss_wrt_mapped_vel=None) -> LossGradient:
        """Pull mapped-space gradients back to world space, then backprop."""
        m = self.mappings[name]
        _, vjp_pos = torch.func.vjp(m.map_pos, self.q_next)
        gq_next = vjp_pos(loss_wrt_mapped_pos)[0]
        gv_next = torch.zeros_like(self.v_next)
        if loss_wrt_mapped_vel is not None:
            _, vjp_vel = torch.func.vjp(m.map_vel, self.q_next, self.v_next)
            gq2, gv2 = vjp_vel(loss_wrt_mapped_vel)
            gq_next = gq_next + gq2
            gv_next = gv_next + gv2
        return self.backprop(gq_next, gv_next)


def mapped_forward_pass(world, state, action, mappings, device=None, **kw
                        ) -> MappedBackpropSnapshot:
    """Reference parity: neural::mappedForwardPass (NeuralUtils.cpp:70)."""
    state, control = _state_action(world, state, action, device,
                                   {k: kw.get(k) for k in ("masses", "scales")})
    nv = world.num_dofs
    return MappedBackpropSnapshot(world, state[:nv], state[nv:], control, mappings, **kw)

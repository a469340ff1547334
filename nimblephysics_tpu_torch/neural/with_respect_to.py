"""WithRespectTo: first-class differentiation variables.

Counterpart of nimblephysics_tpu/neural/with_respect_to.py. Reference
parity: dart/neural/WithRespectTo.hpp:62-75 — POSITION, VELOCITY, FORCE,
ACCELERATION, GROUP_MASSES, GROUP_COMS, GROUP_INERTIAS (+ GROUP_SCALES /
LINEARIZED_MASSES with the biomechanics tier). Each selects one input of a
step function f(q, v, control, body_params); `jacobian_wrt` differentiates
f in it.

A Jacobian here is one forward pass of f and all of its rows in one
batched reverse pass (`jacobian_rows`: torch.autograd.grad with
is_grads_batched, which vmaps the backward over the rows of an identity).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from nimblephysics_tpu_torch.simulation.world import World


@dataclasses.dataclass(frozen=True)
class WithRespectTo:
    name: str

    def __repr__(self):
        return f"WithRespectTo.{self.name}"


POSITION = WithRespectTo("POSITION")
VELOCITY = WithRespectTo("VELOCITY")
FORCE = WithRespectTo("FORCE")
ACCELERATION = WithRespectTo("ACCELERATION")
GROUP_MASSES = WithRespectTo("GROUP_MASSES")
GROUP_COMS = WithRespectTo("GROUP_COMS")
GROUP_INERTIAS = WithRespectTo("GROUP_INERTIAS")
GROUP_SCALES = WithRespectTo("GROUP_SCALES")  # biomechanics tier
LINEARIZED_MASSES = WithRespectTo("LINEARIZED_MASSES")  # biomechanics tier


def dims(world: World, wrt: WithRespectTo) -> int:
    """Reference parity: WithRespectTo::dim(world)."""
    nv = world.num_dofs
    nb = world.num_bodies
    return {
        "POSITION": nv,
        "VELOCITY": nv,
        "FORCE": nv,
        "ACCELERATION": nv,
        "GROUP_MASSES": nb,
        "GROUP_COMS": 3 * nb,
        "GROUP_INERTIAS": 9 * nb,
        "GROUP_SCALES": 3 * nb,
        "LINEARIZED_MASSES": 4 * nb,
    }[wrt.name]


def jacobian_rows(out: torch.Tensor, inputs: Sequence[torch.Tensor],
                  retain_graph: bool = False):
    """d out / d x for each x of `inputs` (leaves that `out` was computed
    from with grad enabled), each (*out.shape, *x.shape), from one batched
    reverse pass over the rows of out; an input out does not reach gets
    zeros."""
    flat = out.reshape(-1)
    eye = torch.eye(flat.shape[0], dtype=out.dtype, device=out.device)
    grads = torch.autograd.grad(flat, list(inputs), eye, retain_graph=retain_graph,
                                is_grads_batched=True, allow_unused=True)
    return [(x.new_zeros(flat.shape[0], *x.shape) if g is None else g).reshape(
        *out.shape, *x.shape) for g, x in zip(grads, inputs)]


def _jacobian(f: Callable, x0: torch.Tensor) -> torch.Tensor:
    x = x0.detach().clone().requires_grad_()
    with torch.enable_grad():
        out = f(x)
    return jacobian_rows(out, [x])[0]


def _default_body_params(world: World, like: torch.Tensor) -> Dict[str, torch.Tensor]:
    from nimblephysics_tpu_torch.dynamics.skeleton import default_body_params

    parts = [default_body_params(sk, dtype=like.dtype, device=like.device)
             for sk in world.skeletons]
    return {k: torch.cat([p[k] for p in parts]) for k in ("masses", "coms", "inertias")}


def jacobian_wrt(
    world: World,
    f: Callable,
    wrt: WithRespectTo,
    q: torch.Tensor,
    v: torch.Tensor,
    control: torch.Tensor,
    body_params: Optional[dict] = None,
):
    """d f / d wrt at (q, v, control, body_params), where f has signature
    f(q, v, control, body_params) -> tensor. The universal entry point the
    reference threads through every Jacobian routine
    (Skeleton::getJacobianOfC(wrt)-style APIs). With no body_params the
    body-parameter variables start from the spec's masses, COMs and
    inertias, on q's device and in its dtype."""
    if body_params is None and (wrt.name.startswith("GROUP") or wrt is LINEARIZED_MASSES):
        body_params = _default_body_params(world, q)

    if wrt is POSITION:
        return _jacobian(lambda x: f(x, v, control, body_params), q)
    if wrt is VELOCITY:
        return _jacobian(lambda x: f(q, x, control, body_params), v)
    if wrt is FORCE:
        return _jacobian(lambda x: f(q, v, x, body_params), control)
    if wrt is GROUP_MASSES:
        return _jacobian(lambda m: f(q, v, control, {**body_params, "masses": m}),
                         body_params["masses"])
    if wrt is GROUP_COMS:
        J = _jacobian(lambda c: f(q, v, control, {**body_params, "coms": c}),
                      body_params["coms"])
        return J.reshape(J.shape[0], -1)
    if wrt is GROUP_INERTIAS:
        J = _jacobian(lambda I: f(q, v, control, {**body_params, "inertias": I}),
                      body_params["inertias"])
        return J.reshape(J.shape[0], -1)
    if wrt is GROUP_SCALES:
        s0 = body_params.get("scales")
        if s0 is None:
            s0 = q.new_ones(world.num_bodies, 3)
        J = _jacobian(lambda sc: f(q, v, control, {**body_params, "scales": sc}), s0)
        return J.reshape(J.shape[0], -1)
    if wrt is LINEARIZED_MASSES:
        # Reference parity: WithRespectToLinearizedMasses
        # (dart/neural/WithRespectToMass.hpp) — theta = [m_b; m_b * com_b]
        # per body (mass + first mass moment), the parameterization in
        # which inverse dynamics is LINEAR (convex mass fitting).
        m0, c0 = body_params["masses"], body_params["coms"]
        theta0 = torch.cat([m0[:, None], m0[:, None] * c0], dim=1)  # (nb, 4)

        def g(theta):
            m = theta[:, 0]
            coms = theta[:, 1:] / torch.clamp(m[:, None], min=1e-12)
            return f(q, v, control, {**body_params, "masses": m, "coms": coms})

        J = _jacobian(g, theta0)
        return J.reshape(J.shape[0], -1)
    raise NotImplementedError(wrt)

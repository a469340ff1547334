"""IKSolver: damped-least-squares inverse kinematics.

Counterpart of nimblephysics_tpu/math/iksolver.py: fixed-iteration
Gauss-Newton with Tikhonov damping, a step clamp and optional bounds.
"""

from __future__ import annotations

from typing import Callable

import torch


def solve_ik(f: Callable[[torch.Tensor], torch.Tensor], target, q_init,
             iterations: int = 20, damping: float = 1e-6, step_clamp: float = 1.0,
             lower=None, upper=None, device=None) -> torch.Tensor:
    """Minimize ||f(q) - target||^2 by damped Gauss-Newton.

    `f` maps q (nq,) to its task coordinates (any differentiable map:
    marker positions, an end-effector pose, the COM); its Jacobian is
    taken by forward mode (torch.func.jacfwd). A tensor q_init runs where
    it lies; numpy or lists go to `device` in float64, the card unless
    device="cpu"."""
    from nimblephysics_tpu_torch.batched.engine import _resolve_device

    if isinstance(q_init, torch.Tensor):
        if device is not None and torch.device(device).type != q_init.device.type:
            raise ValueError(f"q_init lies on {q_init.device}, not on {device}")
        q = q_init
    else:
        q = torch.as_tensor(q_init, dtype=torch.float64, device=_resolve_device(device))

    def on(x):
        return None if x is None else torch.as_tensor(x, dtype=q.dtype, device=q.device)

    target, lower, upper = on(target), on(lower), on(upper)
    jac = torch.func.jacfwd(f)
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    for _ in range(iterations):
        r = f(q) - target
        J = jac(q)
        dq = torch.linalg.solve(J.T @ J + damping * eye, J.T @ r)
        norm = torch.linalg.vector_norm(dq)
        dq = dq * torch.clamp(step_clamp / torch.clamp(norm, min=1e-12), max=1.0)
        q = q - dq
        if lower is not None:
            q = torch.maximum(q, lower)
        if upper is not None:
            q = torch.minimum(q, upper)
    return q

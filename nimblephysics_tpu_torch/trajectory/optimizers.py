"""Trajectory optimizers: SGD/Adam, augmented Lagrangian, host SQP / IPOPT
and Gauss-Newton.

Counterpart of nimblephysics_tpu/trajectory/optimizers.py. Reference
parity: dart/trajectory SGDOptimizer (plain gradient descent) and
IPOptOptimizer (IPOptOptimizer.cpp:41-129 — IPOPT TNLP with best-iterate
recovery and intermediate callbacks). The augmented Lagrangian method
minimizes loss + lambda^T h + 0.5 rho ||h||^2 with Adam on the problem's
device, multipliers and penalty updated between subproblems. Every
optimizer keeps the JAX package's constants, best-iterate recovery,
per-iteration callbacks and Solution fields; gradients come from torch
autograd through the rollout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from nimblephysics_tpu_torch.trajectory.problem import Problem, TrajectoryRollout, jacobian


@dataclasses.dataclass
class Solution:
    """Reference parity: trajectory::Solution (+ per-step records)."""

    x: torch.Tensor
    loss: float
    constraint_violation: float
    rollout: TrajectoryRollout
    loss_history: List[float]


def value_and_grad(f: Callable, x: torch.Tensor, *args):
    """(f(x, *args) detached, d f / d x) by one reverse pass."""
    x = x.detach().clone().requires_grad_()
    with torch.enable_grad():
        val = f(x, *args)
        (g,) = torch.autograd.grad(val, [x])
    return val.detach(), g


def _start(problem: Problem, x0) -> torch.Tensor:
    if x0 is None:
        return problem.initial_guess(problem.start_state)
    return problem.tensor(x0)


def _max_abs(h: torch.Tensor) -> float:
    return float(h.abs().max()) if h.numel() else 0.0


def _no_grad_rollout(problem: Problem, x: torch.Tensor) -> TrajectoryRollout:
    with torch.no_grad():
        return problem.rollout(x)


class SGDOptimizer:
    """Plain first-order descent (reference: SGDOptimizer.cpp), with Adam
    moments because bare SGD on stiff contact problems is hopeless."""

    def __init__(
        self,
        iterations: int = 200,
        learning_rate: float = 1e-2,
        b1: float = 0.9,
        b2: float = 0.999,
    ):
        self.iterations = iterations
        self.lr = learning_rate
        self.b1, self.b2 = b1, b2

    def optimize(self, problem: Problem, x0=None, callback: Optional[Callable] = None
                 ) -> Solution:
        x = _start(problem, x0)
        m, v = torch.zeros_like(x), torch.zeros_like(x)
        best_x, best_loss = x, float("inf")
        history = []
        for t in range(1, self.iterations + 1):
            loss, g = value_and_grad(problem.loss, x)
            loss = float(loss)
            history.append(loss)
            if loss < best_loss:
                best_loss, best_x = loss, x
            if callback is not None:
                callback(t, loss, x)
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            mh = m / (1 - self.b1**t)
            vh = v / (1 - self.b2**t)
            x = x - self.lr * mh / (torch.sqrt(vh) + 1e-8)
        return Solution(best_x, best_loss, 0.0, _no_grad_rollout(problem, best_x), history)


class AugmentedLagrangianOptimizer:
    """NLP solver for constrained shooting problems on the problem's device.

    The functional replacement for the reference's IPOptOptimizer: the
    outer loop updates multipliers/penalty, the inner loop runs Adam on
    L(x) = f(x) + lambda^T h(x) + rho/2 ||h(x)||^2. Keeps the reference's
    best-iterate recovery (setRecoverBest).
    """

    def __init__(
        self,
        outer_iterations: int = 10,
        inner_iterations: int = 100,
        learning_rate: float = 1e-2,
        rho0: float = 10.0,
        rho_growth: float = 4.0,
        tol: float = 1e-6,
    ):
        self.outer = outer_iterations
        self.inner = inner_iterations
        self.lr = learning_rate
        self.rho0 = rho0
        self.rho_growth = rho_growth
        self.tol = tol

    def optimize(self, problem: Problem, x0=None, callback: Optional[Callable] = None
                 ) -> Solution:
        x0 = _start(problem, x0)
        nc = problem.num_constraints

        def lagrangian(x, lam, rho):
            f, h = problem.loss_and_constraints(x)
            if nc == 0:
                return f
            return f + lam @ h + 0.5 * rho * torch.sum(h * h)

        def inner_solve(x, lam, rho):
            # Step size shrinks as the penalty stiffens the subproblem.
            lr = self.lr / float(np.sqrt(max(rho / self.rho0, 1.0)))
            m, vv = torch.zeros_like(x), torch.zeros_like(x)
            for t in range(self.inner):
                _, g = value_and_grad(lagrangian, x, lam, rho)
                m = 0.9 * m + 0.1 * g
                vv = 0.999 * vv + 0.001 * g * g
                mh = m / (1 - 0.9 ** (t + 1.0))
                vh = vv / (1 - 0.999 ** (t + 1.0))
                x = x - lr * mh / (torch.sqrt(vh) + 1e-8)
            return x

        x = x0
        lam = x0.new_zeros(nc)
        rho = float(self.rho0)
        best = None
        history = []
        prev_viol = float("inf")
        for k in range(self.outer):
            x = inner_solve(x, lam, rho)
            with torch.no_grad():
                f, h = problem.loss_and_constraints(x)
            viol = _max_abs(h) if nc else 0.0
            history.append(float(f))
            if callback is not None:
                callback(k, float(f), viol, x)
            # Best-iterate recovery weighted by feasibility.
            score = float(f) + 1e3 * viol
            if best is None or score < best[0]:
                best = (score, x, float(f), viol)
            if nc:
                lam = lam + rho * h
                # LANCELOT-style rule: grow the penalty only when the
                # violation stalls; growing it unconditionally makes the
                # inner subproblem stiffer than the fixed-budget inner
                # solver can handle.
                if viol > 0.25 * prev_viol:
                    rho = min(rho * self.rho_growth, 1e8)
                prev_viol = viol
            if viol < self.tol and k > 0:
                break
        _, x_best, f_best, viol_best = best
        return Solution(x_best, f_best, viol_best, _no_grad_rollout(problem, x_best), history)


# Reference-familiar alias: the role IPOptOptimizer plays in the reference.
IPOptOptimizer = AugmentedLagrangianOptimizer


class HostInteriorPointOptimizer:
    """Host interior-point solve with device-computed derivatives — the
    TNLP adapter role of the reference's IPOptOptimizer
    (IPOptOptimizer.cpp:41-129: wrap the shooting problem as an NLP, hand
    it to a host interior-point engine, recover the best iterate).

    Engine selection: real IPOPT via cyipopt where that package is
    installed, else scipy's SLSQP sequential quadratic programming
    engine, which handles the same equality-constrained smooth NLP
    class. Loss gradients come from reverse-mode autograd on the
    problem's device; the knot-constraint Jacobian uses the per-step
    products (constraint_jacobian_scan) when the problem provides them.
    Keeps best-iterate recovery (setRecoverBest) and per-iteration
    callbacks."""

    def __init__(self, max_iterations: int = 100, tol: float = 1e-8):
        self.max_iterations = max_iterations
        self.tol = tol

    def optimize(self, problem: Problem, x0=None, callback: Optional[Callable] = None
                 ) -> Solution:
        import scipy.optimize as sopt

        x0 = _start(problem, x0)
        nc = problem.num_constraints
        cjac = getattr(problem, "constraint_jacobian_scan", None)
        if cjac is None:
            def cjac(x):
                return jacobian(problem.constraints, x)

        def host(x):
            return x.detach().cpu().numpy().astype(np.float64)

        last = {}  # the constraints of fun's last x, from its rollout

        def cons(x):
            if "x" in last and np.array_equal(last["x"], x):
                return last["h"]
            with torch.no_grad():
                return host(problem.constraints(problem.tensor(x)))

        def loss_and_cons(xt):
            f, h = problem.loss_and_constraints(xt)
            last["h"] = host(h)
            return f

        best = {"score": float("inf")}
        history: List[float] = []

        def fun(x):
            f, g = value_and_grad(loss_and_cons, problem.tensor(x))
            last["x"] = np.array(x, dtype=np.float64)
            f = float(f)
            viol = float(np.max(np.abs(last["h"]))) if nc else 0.0
            history.append(f)
            score = f + 1e3 * viol
            if score < best["score"]:
                best.update(score=score, x=np.asarray(x).copy(), f=f, viol=viol)
            if callback is not None:
                callback(len(history), f, viol, x)
            return f, host(g)

        x_start = host(x0)
        try:
            from cyipopt import minimize_ipopt  # optional real IPOPT

            constraints = []
            if nc:
                constraints.append(sopt.NonlinearConstraint(
                    cons, 0.0, 0.0, jac=lambda x: host(cjac(problem.tensor(x)))))
            minimize_ipopt(fun, x_start, jac=True, constraints=constraints,
                           options={"maxiter": self.max_iterations, "tol": self.tol})
        except ImportError:
            constraints = []
            if nc:
                constraints.append(dict(
                    type="eq", fun=cons, jac=lambda x: host(cjac(problem.tensor(x)))))
            sopt.minimize(fun, x_start, jac=True, method="SLSQP", constraints=constraints,
                          options={"maxiter": self.max_iterations, "ftol": self.tol})

        x_best = problem.tensor(best.get("x", x_start))
        if "f" in best:
            f_best = best["f"]
        else:
            with torch.no_grad():
                f_best = float(problem.loss(x_best))
        return Solution(
            x=x_best,
            loss=f_best,
            constraint_violation=best.get("viol", 0.0),
            rollout=_no_grad_rollout(problem, x_best),
            loss_history=history,
        )


class GaussNewtonOptimizer:
    """Second-order (Gauss-Newton SQP) solver for shooting problems whose
    loss is a sum of squared residuals — the class the reference solves
    with IPOPT's second-order mode.

    Method: augmented-Lagrangian Gauss-Newton with Levenberg-Marquardt
    damping. Each inner iterate solves
        (J^T J + mu D) dx = -J^T r_aug,
        r_aug = [ r(x) ; sqrt(rho) (c(x) + lam / rho) ]
    with J = d r_aug / dx (a reverse pass by rows through the rollout, or
    the per-step products with structured_jacobian=True), mu adapted by
    the LM gain ratio; the outer loop updates multipliers lam += rho c and
    stiffens rho when knot violation stalls. The KKT solve is a dense
    Cholesky (torch.linalg.cholesky / torch.cholesky_solve).
    """

    def __init__(
        self,
        outer_iterations: int = 8,
        inner_iterations: int = 10,
        rho0: float = 10.0,
        rho_growth: float = 4.0,
        mu0: float = 1e-4,
        tol: float = 1e-8,
    ):
        self.outer = outer_iterations
        self.inner = inner_iterations
        self.rho0 = rho0
        self.rho_growth = rho_growth
        self.mu0 = mu0
        self.tol = tol

    def optimize(
        self,
        problem: Problem,
        residuals: Callable[[torch.Tensor], torch.Tensor],
        x0=None,
        callback: Optional[Callable] = None,
        structured_jacobian: bool = False,
    ) -> Solution:
        """`residuals(x)` must satisfy problem.loss(x) ~= sum(residuals^2)
        (the optimizer minimizes the residual form).

        structured_jacobian=True builds J from the per-step
        state-transition products (problem.constraint_jacobian_scan +
        residuals.jacobian, e.g. a TerminalResiduals) instead of a reverse
        pass through the whole rollout — the same values (reference analog:
        MultiShot::backpropJacobian accumulates KnotJacobians per step,
        MultiShot.cpp:475-584)."""
        x0 = _start(problem, x0)
        nc = problem.num_constraints

        def r_aug(x, lam, rho):
            r = residuals(x)
            if nc == 0:
                return r
            h = problem.constraints(x)
            return torch.cat([r, float(np.sqrt(rho)) * (h + lam / rho)])

        def jac_aug(x, lam, rho):
            if not structured_jacobian:
                return jacobian(lambda xx: r_aug(xx, lam, rho), x)
            res_jac = getattr(residuals, "jacobian", None)
            Jr = res_jac(x) if res_jac is not None else jacobian(residuals, x)
            if nc == 0:
                return Jr
            Jh = problem.constraint_jacobian_scan(x)
            return torch.cat([Jr, float(np.sqrt(rho)) * Jh], dim=0)

        def lm_step(x, lam, rho, mu):
            with torch.no_grad():
                r = r_aug(x, lam, rho)
            J = jac_aug(x, lam, rho)
            g = J.T @ r
            H = J.T @ J
            # Marquardt scaling: damp with mu * diag(H), not mu * I —
            # shooting problems mix variables whose sensitivities span
            # orders of magnitude (wrist vs base torques), and isotropic
            # damping crushes the low-sensitivity directions.
            D = torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
            dx = torch.cholesky_solve(-g[:, None], torch.linalg.cholesky(H + mu * D))[:, 0]
            f0 = 0.5 * float(torch.sum(r * r))
            with torch.no_grad():
                r_new = r_aug(x + dx, lam, rho)
            f1 = 0.5 * float(torch.sum(r_new * r_new))
            pred = float(-(g @ dx) - 0.5 * dx @ (H @ dx))
            ratio = (f0 - f1) / max(pred, 1e-30)
            accept = f1 < f0
            if accept:
                x = x + dx
            if accept and ratio > 0.5:
                mu = max(mu / 3.0, 1e-12)
            elif not accept:
                mu = mu * 4.0
            return x, mu, f1, f0

        x = x0
        lam = x0.new_zeros(nc)
        rho = float(self.rho0)
        mu = float(self.mu0)
        history = []
        best = None
        prev_viol = float("inf")
        for k in range(self.outer):
            for _ in range(self.inner):
                x, mu, f1, f0 = lm_step(x, lam, rho, mu)
                history.append(f1)
                if abs(f0 - f1) < self.tol * (1.0 + abs(f0)):
                    break
            with torch.no_grad():
                loss, h = problem.loss_and_constraints(x)
            loss = float(loss)
            viol = _max_abs(h) if nc else 0.0
            if callback is not None:
                callback(k, loss, viol)
            if best is None or (
                viol <= best[2] * 1.001 and loss < best[1]
            ) or viol < best[2] * 0.3:
                best = (x, loss, viol)
            if nc:
                lam = lam + rho * h
                if viol > 0.3 * prev_viol:
                    rho = rho * self.rho_growth
                prev_viol = viol
        x, loss, viol = best
        return Solution(
            x=x,
            loss=loss,
            constraint_violation=viol,
            rollout=_no_grad_rollout(problem, x),
            loss_history=history,
        )

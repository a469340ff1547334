"""One-dimensional function specs for the spline-driven custom joints.

Counterpart of nimblephysics_tpu/math/splines.py: the OpenSim function
family of a CustomJoint's transform axes, LinearFunction, Constant,
PolynomialFunction, SimmSpline (a natural cubic) and MultiplierFunction.
Knots are static plan data; a spline's knot second derivatives are solved
on the host in numpy, and outside the knots it extrapolates linearly.
Evaluation is elementwise on a tensor of any shape, differentiable in it,
with the first and second derivatives written in closed form from the
same cubic (the JAX package takes the first by jax.grad).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Fn:
    """Tagged 1-D function spec (static)."""

    kind: str  # 'linear' | 'constant' | 'polynomial' | 'spline'
    params: Tuple  # static numpy payloads
    scale: float = 1.0  # MultiplierFunction wrapper
    _tensors: Dict = dataclasses.field(default_factory=dict, repr=False)

    def __call__(self, x):
        return self.scale * _eval(self, x, 0)

    def derivative(self, x):
        """f'(x), closed form."""
        return self.scale * _eval(self, x, 1)

    def second_derivative(self, x):
        """f''(x), closed form (0 where the spline extrapolates)."""
        return self.scale * _eval(self, x, 2)

    def knots(self, dtype, device):
        """A spline's knots xs, values ys, second derivatives m and end
        slopes (s0, sN) as tensors, built once per dtype and device."""
        key = (dtype, torch.device(device))
        if key not in self._tensors:
            xs, ys, m = self.params
            s0 = (ys[1] - ys[0]) / (xs[1] - xs[0]) - (xs[1] - xs[0]) * m[0] / 3.0 - (
                xs[1] - xs[0]) * m[1] / 6.0
            sN = (ys[-1] - ys[-2]) / (xs[-1] - xs[-2]) + (xs[-1] - xs[-2]) * m[-1] / 3.0 + (
                xs[-1] - xs[-2]) * m[-2] / 6.0
            self._tensors[key] = tuple(
                torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
                for a in (xs, ys, m, s0, sN))
        return self._tensors[key]


def linear(a: float, b: float) -> Fn:
    """f(x) = a x + b (OpenSim LinearFunction coefficients [a, b])."""
    return Fn("linear", (float(a), float(b)))


def constant(v: float) -> Fn:
    return Fn("constant", (float(v),))


def polynomial(coeffs) -> Fn:
    """f(x) = sum_i c_i x^(n-1-i) (OpenSim PolynomialFunction order)."""
    return Fn("polynomial", (np.asarray(coeffs, dtype=np.float64),))


def simm_spline(xs, ys) -> Fn:
    """Natural cubic spline through (xs, ys) (OpenSim SimmSpline); two
    knots give the line through them."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    n = len(xs)
    assert n >= 2
    if n == 2:
        a = (ys[1] - ys[0]) / (xs[1] - xs[0])
        return linear(a, ys[0] - a * xs[0])
    # Tridiagonal system of the natural spline's knot second derivatives.
    h = np.diff(xs)
    A = np.zeros((n, n))
    r = np.zeros(n)
    A[0, 0] = 1.0
    A[-1, -1] = 1.0
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1] / 6.0
        A[i, i] = (h[i - 1] + h[i]) / 3.0
        A[i, i + 1] = h[i] / 6.0
        r[i] = (ys[i + 1] - ys[i]) / h[i] - (ys[i] - ys[i - 1]) / h[i - 1]
    m = np.linalg.solve(A, r)
    return Fn("spline", (xs, ys, m))


def multiplier(inner: Fn, scale: float) -> Fn:
    return Fn(inner.kind, inner.params, scale=float(scale) * inner.scale)


def _eval(fn: Fn, x, order: int):
    """The order-th derivative (0, 1 or 2) of fn, unscaled, at x."""
    if fn.kind == "constant":
        return (fn.params[0] if order == 0 else 0.0) + 0.0 * x
    if fn.kind == "linear":
        a, b = fn.params
        return (a * x + b, a + 0.0 * x, 0.0 * x)[order]
    if fn.kind == "polynomial":
        (c,) = fn.params
        n = len(c)
        coef = [float(ci) for ci in c]
        for _ in range(order):  # differentiate the coefficients
            coef = [ci * (n - 1 - i) for i, ci in enumerate(coef[:-1])]
            n -= 1
        out = torch.zeros_like(x)
        for ci in coef:
            out = out * x + ci
        return out
    if fn.kind == "spline":
        xs, ys, m, s0, sN = fn.knots(x.dtype, x.device)
        n = xs.shape[0]
        # Left side, as jnp.searchsorted.
        i = torch.clamp(torch.searchsorted(xs, x.detach().reshape(-1)).reshape(x.shape) - 1,
                        0, n - 2)
        x0, x1 = xs[i], xs[i + 1]
        y0, y1 = ys[i], ys[i + 1]
        m0, m1 = m[i], m[i + 1]
        h = x1 - x0
        t = (x - x0) / h
        if order == 0:
            val = ((1 - t) * y0 + t * y1 + ((1 - t) ** 3 - (1 - t)) * m0 * h * h / 6.0
                   + (t**3 - t) * m1 * h * h / 6.0)
            lo, hi = ys[0] + s0 * (x - xs[0]), ys[-1] + sN * (x - xs[-1])
        elif order == 1:
            val = (y1 - y0 + (1.0 - 3.0 * (1 - t) ** 2) * m0 * h * h / 6.0
                   + (3.0 * t**2 - 1.0) * m1 * h * h / 6.0) / h
            lo, hi = s0 + 0.0 * x, sN + 0.0 * x
        else:
            val = (1 - t) * m0 + t * m1
            lo = hi = 0.0 * x
        val = torch.where(x < xs[0], lo, val)
        return torch.where(x > xs[-1], hi, val)
    raise NotImplementedError(fn.kind)

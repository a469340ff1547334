"""Finite differencing with Ridders' extrapolation — the gradient oracle.

The port's own copy of nimblephysics_tpu/math/finite_difference.py (numpy
only). Reference parity: dart/math/FiniteDifference.hpp:18-57
(`finiteDifference`, "if using Ridders, epsilon should be >= 1e-4").
BackpropSnapshot.finite_difference_state_jacobian and the tests hold the
analytical Jacobians against it.

Host-side utility (numpy): this is a test oracle, not a compute-path op.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

_TAB_SIZE = 10
_CON = 1.4
_CON2 = _CON * _CON
_SAFE = 2.0
_BIG = 1e30


def ridders_derivative(
    f: Callable[[float], np.ndarray], h: float = 1e-3
) -> np.ndarray:
    """Ridders' method for d f(eps)/d eps at eps = 0.

    `f(eps)` must return an array; central differences with Richardson
    extrapolation over a Neville tableau, stopping when error grows
    (mirrors the tableau algorithm used by the reference's
    finiteDifferenceRiddersJacobian family).
    """
    a = np.empty((_TAB_SIZE, _TAB_SIZE), dtype=object)
    hh = h
    a[0][0] = (np.asarray(f(hh), dtype=np.float64) - np.asarray(f(-hh))) / (
        2.0 * hh
    )
    ans = a[0][0]
    err = _BIG
    for i in range(1, _TAB_SIZE):
        hh /= _CON
        a[0][i] = (np.asarray(f(hh), dtype=np.float64) - np.asarray(f(-hh))) / (
            2.0 * hh
        )
        fac = _CON2
        for j in range(1, i + 1):
            a[j][i] = (a[j - 1][i] * fac - a[j - 1][i - 1]) / (fac - 1.0)
            fac *= _CON2
            errt = max(
                np.max(np.abs(a[j][i] - a[j - 1][i])),
                np.max(np.abs(a[j][i] - a[j - 1][i - 1])),
            )
            if errt <= err:
                err = errt
                ans = a[j][i]
        if np.max(np.abs(a[i][i] - a[i - 1][i - 1])) >= _SAFE * err:
            break
    return np.asarray(ans)


def finite_difference_jacobian(
    f: Callable[[np.ndarray], np.ndarray],
    x: np.ndarray,
    use_ridders: bool = True,
    eps: float = 1e-4,
) -> np.ndarray:
    """Jacobian of f at x: rows = outputs, cols = inputs.

    Reference parity: math::finiteDifference (FiniteDifference.hpp:19-57).
    """
    x = np.asarray(x, dtype=np.float64)
    y0 = np.asarray(f(x), dtype=np.float64)
    jac = np.zeros((y0.size, x.size))
    for i in range(x.size):
        def f_eps(h, i=i):
            xp = x.copy().reshape(-1)
            xp[i] += h
            return np.asarray(f(xp.reshape(x.shape))).reshape(-1)

        if use_ridders:
            col = ridders_derivative(f_eps, h=max(eps, 1e-4))
        else:
            col = (f_eps(eps) - f_eps(-eps)) / (2.0 * eps)
        jac[:, i] = col
    return jac

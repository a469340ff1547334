"""Small-matrix algebra on world batches in the trailing axis.

Counterpart of nimblephysics_tpu/batched/linalg.py, with the same
trailing-batch layout at every function: a (3, B) vector batch, an
(n, n, B) matrix batch. Products are broadcast multiply + reduce over the
small leading axes. Factorizations move the batch to the front,
(B, n, n), where torch.linalg works batch-major; the Cholesky keeps the
reference's pivot guard sqrt(max(s, eps or 1e-30)), which
torch.linalg.cholesky does not have (it raises, and syncs with the host,
on a matrix that is not positive definite).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def mv(A, x):
    """(m, k, B) @ (k, B) -> (m, B)."""
    return torch.sum(A * x[None, :, :], dim=1)


def mtv(A, x):
    """A^T x: (k, m, B), (k, B) -> (m, B)."""
    return torch.sum(A * x[:, None, :], dim=0)


def mm(A, B):
    """(m, k, B-or-1) @ (k, n, B-or-1) -> (m, n, B)."""
    return torch.sum(A[:, :, None, :] * B[None, :, :, :], dim=1)


def mtm(A, B):
    """A^T B: (k, m, B-or-1), (k, n, B-or-1) -> (m, n, B)."""
    return torch.sum(A[:, :, None, :] * B[:, None, :, :], dim=0)


def dot(a, b):
    """(k, B) . (k, B) -> (B,)."""
    return torch.sum(a * b, dim=0)


def cross(a, b):
    """(3, B) x (3, B) -> (3, B)."""
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def cross_cols(p, A):
    """[p]x applied to every column: (3, B), (3, n, B) -> (3, n, B)."""
    return torch.stack(
        [
            p[1, None] * A[2] - p[2, None] * A[1],
            p[2, None] * A[0] - p[0, None] * A[2],
            p[0, None] * A[1] - p[1, None] * A[0],
        ]
    )


def gram(U, V):
    """Batched Gram product U^T V: (n, r, B) x (n, s, B) -> (r, s, B)."""
    return torch.einsum("irb,isb->rsb", U, V)


def skew(w):
    """(3, B) -> (3, 3, B)."""
    z = torch.zeros_like(w[0])
    return torch.stack(
        [
            torch.stack([z, -w[2], w[1]]),
            torch.stack([w[2], z, -w[0]]),
            torch.stack([-w[1], w[0], z]),
        ]
    )


def _eye3(w):
    return torch.eye(3, dtype=w.dtype, device=w.device)[..., None]


def _taylor_thresh(dtype) -> float:
    """theta^2 below which the rotation maps take their Taylor branches:
    the dtype's machine epsilon. Large enough that the generic branch's
    derivatives never see theta^4 underflow to subnormals (float32
    theta ~ 1e-11 gives theta^4 ~ 1e-44, then inf * 0 = NaN through
    (1 - cos t)/t^2), small enough that the Taylor error O(t2^2) stays
    below eps^2."""
    return float(torch.finfo(dtype).eps)


def _so3_coeffs(w):
    """a = sin t / t, b = (1 - cos t)/t^2 and c = (t - sin t)/t^3 of
    t = |w| for w (3, B), each (B,) with its Taylor branch below
    _taylor_thresh, then the branch mask, t^2, the guarded t^2 and the
    guarded t. Every guard is a double where: the generic branch sees
    theta^2 = 1 where it is not taken, since torch.where, like jnp.where,
    multiplies the unused branch's gradient by zero and 0 * inf is NaN."""
    t2 = torch.sum(w * w, dim=0)
    small = t2 < _taylor_thresh(w.dtype)
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    s = torch.sin(t)
    a = torch.where(small, 1.0 - t2 / 6.0, s / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - s) / (t2s * t))
    return a, b, c, small, t2, t2s, t


def exp_so3(w):
    """Batched exp map (3, B) -> (3, 3, B), gradient-safe at |w| -> 0:
    I + a [w]x + b [w]x^2."""
    a, b, *_ = _so3_coeffs(w)
    K = skew(w)
    return _eye3(w) + a * K + b * mm(K, K)


def so3_right_jacobian_b(w):
    """Batched right Jacobian of SO(3), (3, B) -> (3, 3, B):
    Jr(w) = I - (1 - cos t)/t^2 [w]x + (t - sin t)/t^3 [w]x^2."""
    _, b, c, *_ = _so3_coeffs(w)
    K = skew(w)
    return _eye3(w) - b * K + c * mm(K, K)


def so3_coeff_rates(w):
    """(a, b, c) of _so3_coeffs and their radial rates over t, a'(t)/t,
    b'(t)/t and c'(t)/t, each (B,), Taylor-guarded the same way. Along a
    direction d, d/de a(|w + e d|) = (a'(t)/t) (w . d)."""
    a, b, c, small, t2, t2s, t = _so3_coeffs(w)
    s, co = torch.sin(t), torch.cos(t)
    t4 = t2s * t2s
    da = torch.where(small, -1.0 / 3.0 + t2 / 30.0, (t * co - s) / (t2s * t))
    db = torch.where(small, -1.0 / 12.0 + t2 / 180.0, (t * s - 2.0 * (1.0 - co)) / t4)
    dc = torch.where(small, -1.0 / 60.0 + t2 / 1260.0,
                     (3.0 * s - t * (2.0 + co)) / (t4 * t))
    return a, b, c, da, db, dc


def log_so3(R):
    """Batched log map (3, 3, B) -> (3, B), gradient-safe near the
    identity and near pi.

    The angle is atan2(|antisym|/2, cos), not arccos, whose gradient at
    cos = +-1 is 0 * inf = NaN even where the cotangent is zero (every
    box-stack world starts at the identity); the sqrt is double-where
    guarded where sin t -> 0, at t = 0 and at t = pi.
    """
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    v = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    asq = torch.sum(v * v, dim=0)
    a_degen = asq < 4.0 * _taylor_thresh(R.dtype)
    sin_raw = 0.5 * torch.sqrt(torch.where(a_degen, torch.ones_like(asq), asq))
    t_gen = torch.atan2(sin_raw, cos_t)
    t_degen = torch.where(cos_t > 0.0, torch.zeros_like(cos_t),
                          torch.full_like(cos_t, torch.pi))
    t = torch.where(a_degen, t_degen, t_gen)
    sin_t = torch.sin(t)
    small = torch.abs(sin_t) < 1e-6
    near_pi = cos_t < -1.0 + 1e-6
    # Generic branch: w = t / (2 sin t) v.
    coef = torch.where(small, 0.5 + t * t / 12.0,
                       t / torch.where(small, torch.ones_like(sin_t), 2.0 * sin_t))
    w_gen = coef * v
    # Near pi: w = t times the unit column of (R + I)/2 with the largest
    # diagonal entry, signed to agree with v.
    Bp = (R + _eye3(R)) * 0.5
    d = torch.stack([Bp[0, 0], Bp[1, 1], Bp[2, 2]])
    k = torch.argmax(d, dim=0)
    cols = Bp.permute(1, 0, 2)  # (3 columns, 3, B)
    col = torch.gather(cols, 0, k[None, None, :].expand(1, 3, -1))[0]
    nrm = torch.sqrt(torch.clamp(torch.sum(col * col, dim=0), min=1e-30))
    w_pi = t * col / nrm
    sgn = torch.where(torch.sum(w_pi * v, dim=0) < 0.0,
                      -torch.ones_like(t), torch.ones_like(t))
    return torch.where(near_pi, w_pi * sgn, w_gen)


def ad_apply(V, U):
    """Spatial cross product ad_V U for [w; v] twists: (6, B) each."""
    w1, v1 = V[:3], V[3:]
    w2, v2 = U[:3], U[3:]
    return torch.cat([cross(w1, w2), cross(v1, w2) + cross(w1, v2)])


def dad_apply(V, F):
    """Dual spatial cross ad(V)^T F = [-w x m - v x f; -w x f]."""
    w, v = V[:3], V[3:]
    m, f = F[:3], F[3:]
    return torch.cat([-cross(w, m) - cross(v, f), -cross(w, f)])


# -- factorizations (batch-major inside) ------------------------------------


def cholesky(A, eps: float = 0.0):
    """Lower Cholesky of an SPD batch: (n, n, B) -> (n, n, B).

    Column by column (left-looking) over the batch-major view; each pivot
    is sqrt(max(s, eps or 1e-30)) on every path, so a matrix that is only
    semi-definite up to roundoff gives a finite factor instead of NaN.
    """
    n = A.shape[0]
    Ab = A.permute(2, 0, 1)  # (B, n, n)
    floor = eps if eps else 1e-30
    L = Ab.new_zeros(Ab.shape[0], n, 0)
    for j in range(n):
        s = Ab[:, j:, j]  # (B, n - j)
        if j:
            Lj = L[:, j:, :]  # (B, n - j, j)
            s = s - torch.sum(Lj * Lj[:, :1, :], dim=2)
        d = torch.sqrt(torch.clamp(s[:, :1], min=floor))
        col = torch.cat([Ab.new_zeros(Ab.shape[0], j), d, s[:, 1:] * (1.0 / d)], 1)
        L = torch.cat([L, col[:, :, None]], dim=2)
    return L.permute(1, 2, 0)


def solve_tri_lower(L, B):
    """L Y = B with L (n, n, B) lower-triangular, B (n, m, B) -> Y."""
    Y = torch.linalg.solve_triangular(
        L.permute(2, 0, 1), B.permute(2, 0, 1), upper=False
    )
    return Y.permute(1, 2, 0)


def solve_tri_upper_t(L, B):
    """L^T X = B (back substitution), B (n, m, B) -> X."""
    X = torch.linalg.solve_triangular(
        L.permute(2, 1, 0), B.permute(2, 0, 1), upper=True
    )
    return X.permute(1, 2, 0)


def solve_tri_lower_vec(L, b):
    """L y = b with b (n, B) -> y (n, B)."""
    return solve_tri_lower(L, b[:, None, :])[:, 0, :]


def solve_tri_upper_t_vec(L, b):
    return solve_tri_upper_t(L, b[:, None, :])[:, 0, :]


# -- block-diagonal factorizations (one block per skeleton) ------------------


def block_cholesky(Ms: Sequence) -> List:
    """Per-block lower Cholesky; zero-dof blocks pass through."""
    return [cholesky(M) if M.shape[0] else M for M in Ms]


def block_solve_tri_lower(Ls: Sequence, slices: Sequence[Tuple[int, int]], B):
    """Block-diag L Y = B; B (n, m, B) split along axis 0 by `slices`."""
    return torch.cat(
        [
            solve_tri_lower(L, B[s:e]) if e > s else B[s:e]
            for L, (s, e) in zip(Ls, slices)
        ],
        dim=0,
    )


def block_solve_tri_upper_t(
    Ls: Sequence, slices: Sequence[Tuple[int, int]], B
):
    """Block-diag L^T X = B; B (n, m, B) split along axis 0 by `slices`."""
    return torch.cat(
        [
            solve_tri_upper_t(L, B[s:e]) if e > s else B[s:e]
            for L, (s, e) in zip(Ls, slices)
        ],
        dim=0,
    )


def block_solve_tri_lower_vec(Ls, slices, b):
    return block_solve_tri_lower(Ls, slices, b[:, None, :])[:, 0, :]


def block_solve_tri_upper_t_vec(Ls, slices, b):
    return block_solve_tri_upper_t(Ls, slices, b[:, None, :])[:, 0, :]

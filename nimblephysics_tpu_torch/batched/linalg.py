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






def cross(a, b):
    """(3, B) x (3, B) -> (3, B)."""
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
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

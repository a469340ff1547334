"""The boxed LCP: static row metadata, dtype-aware tolerances, and the
solver of one world.

Counterpart of nimblephysics_tpu/constraint/lcp.py: LcpMeta, subset_meta,
_dtype_tol and _dtype_ridge, and boxed_lcp with what it calls (the seed,
the classification, the refinement rounds, the gathered pinned solve, the
validity check and the failure ladder). The batched solver is
batched/lcp.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class LcpMeta:
    """Static row metadata for one world's constraint block.

    findex[i] = index of the normal row bounding friction row i, else -1
    (reference: ConstraintInfo::findex, ContactConstraint.cpp:385-389).
    """

    findex: np.ndarray  # (n,) int32
    is_friction: np.ndarray  # (n,) bool
    # Constant box bounds per row; None = [0, inf) for every row.
    lo_const: Optional[np.ndarray] = None
    hi_const: Optional[np.ndarray] = None
    iterations: int = 64
    tol: float = 1e-9  # classification tolerance (floored per dtype)
    ridge: float = 1e-10  # relative Tikhonov ridge (floored per dtype)
    refine_rounds: int = 3
    seed_pgs_sweeps: int = 16
    k_active: int = 0
    solver: str = "apgd"

    @property
    def n(self) -> int:
        return len(self.findex)


def subset_meta(meta: LcpMeta, rows: np.ndarray, nv: int) -> LcpMeta:
    """The row plan restricted to `rows` (one static constraint island of
    nv dofs): findex remapped to the new positions, bounds taken along,
    k_active re-sized. A friction row travels with its normal row (they
    share a contact, hence an island); splitting them raises."""
    rows = np.asarray(rows, dtype=np.int64)
    pos = np.full(meta.n, -1, dtype=np.int64)
    pos[rows] = np.arange(len(rows))
    fi = meta.findex[rows]
    fi_new = np.where(fi >= 0, pos[np.maximum(fi, 0)], -1).astype(np.int32)
    if np.any((fi >= 0) & (fi_new < 0)):
        raise ValueError("friction row split from its normal row")
    return dataclasses.replace(
        meta,
        findex=fi_new,
        is_friction=meta.is_friction[rows],
        lo_const=None if meta.lo_const is None else meta.lo_const[rows],
        hi_const=None if meta.hi_const is None else meta.hi_const[rows],
        k_active=min(len(rows), max(16, 2 * nv + 8)),
    )


def _dtype_tol(meta: LcpMeta, dtype: torch.dtype) -> float:
    return max(meta.tol, 100.0 * float(torch.finfo(dtype).eps))


def _dtype_ridge(meta: LcpMeta, dtype: torch.dtype) -> float:
    return max(meta.ridge, 50.0 * float(torch.finfo(dtype).eps))


# ---------------------------------------------------------------------------
# The boxed LCP of one world: F (n, r), b/mu/z (n,)
# ---------------------------------------------------------------------------
#
# The batched solver's row rules (batched/lcp.py: _classify, _refine_masks,
# _lcp_valid) and seed (batched/lcp_cuda.py: apgd_plain, pgs_plain) run
# here on a batch of one, and so does the pinned solve at cfm = 0; the
# ladder's softened rungs keep the JAX package's gathered K x K form with
# its ridged normal equations (_pinned_solve). As in the JAX package, the
# seed is differentiable (unrolled iterations, on every device: no kernel
# runs on this path), the masks and validity flags are not.


def _batched(x):
    """(n, ...) -> (n, ..., 1): a batch of one in batched/lcp's layout."""
    return x[..., None]


def _Av(F, cfm, y):
    """A y = F (F^T y) + cfm y without forming A."""
    return F @ (F.T @ y) + cfm * y


def _pgs(meta: LcpMeta, F, cfm, b, mu, z0):
    """meta.iterations sweeps of projected Gauss-Seidel (running u = F^T
    z, O(r) a row, no write in place)."""
    from nimblephysics_tpu_torch.batched.lcp_cuda import pgs_plain

    return pgs_plain(meta, _batched(F), cfm, _batched(b), _batched(mu), _batched(z0))[:, 0]


def _apgd(meta: LcpMeta, F, cfm, b, mu, z0):
    """meta.iterations Nesterov steps of projected gradient on A z - b."""
    from nimblephysics_tpu_torch.batched.lcp_cuda import apgd_plain

    return apgd_plain(meta, _batched(F), cfm, _batched(b), _batched(mu), _batched(z0))[:, 0]


def _classify(meta: LcpMeta, F, cfm, b, mu, z):
    """CLAMPING / UPPER_BOUND / at-upper-bound masks of a solution, with
    the reference tie-breaks."""
    from nimblephysics_tpu_torch.batched import lcp as blcp

    out = blcp._classify(meta, _batched(F), cfm, _batched(b), _batched(mu), _batched(z))
    return tuple(x[:, 0] for x in out)


def _lcp_valid(meta: LcpMeta, F, cfm, b, mu, z):
    """Is z a valid boxed-LCP solution (scale-aware tolerances)? () bool."""
    from nimblephysics_tpu_torch.batched import lcp as blcp

    return blcp._lcp_valid(meta, _batched(F), cfm, _batched(b), _batched(mu), _batched(z))[0]


def _ridge_solve(meta: LcpMeta, M, rhs, polish: bool = True):
    """Least squares M x = rhs through the ridged normal equations
    (M^T M + eps (tr(M^T M)/k + 1) I) x = M^T rhs, with one step of
    iterative refinement when polish."""
    k = M.shape[-1]
    MtM = M.T @ M
    eps = _dtype_ridge(meta, M.dtype) * (torch.trace(MtM) / k + 1.0)
    L = torch.linalg.cholesky_ex(MtM + eps * torch.eye(k, dtype=M.dtype, device=M.device))[0]
    Mtr = M.T @ rhs
    x = torch.cholesky_solve(Mtr[:, None], L)[:, 0]
    if not polish:
        return x
    return x + torch.cholesky_solve((Mtr - M.T @ (M @ x))[:, None], L)[:, 0]


def _pinned_solve(meta: LcpMeta, F, cfm, b, mu, clamping, upper, sign_u, at_hi=None,
                  polish: bool = True):
    """The exact solve of the pinned active set, z over every row.

    The system holds the first meta.k_active clamping rows in row order
    (the JAX package's gathered K-row system). At cfm = 0 it is solved
    rank-factored (batched/lcp._pinned_solve on a batch of one): z = V
    alpha lies in the row space of the clamping rows, so no roundoff
    lands in F^T's null space, where a redundant contact set leaves z
    free. At cfm > 0 (the ladder's softened rungs) it is solved in the
    JAX package's gathered form below, whose ridge decides, as there,
    whether an inconsistent softened system passes the validity check.

    Gathered form: with P = diag(c) + E (an UPPER_BOUND friction row
    coupled to its normal row by its signed mu), the clamping rows solve
    (A P)|_C z_C = b_C; A P = F H^T + cfm P with H = P^T F. The clamping
    rows are gathered into a K = meta.k_active row system, solved by
    _ridge_solve. A non-friction row pinned at a finite constant bound
    carries that bound as a fixed impulse.
    """
    from nimblephysics_tpu_torch.batched import lcp as blcp

    n = meta.n
    K = min(meta.k_active, n) if meta.k_active else n
    clamping = clamping & (torch.cumsum(clamping.to(torch.int64), 0) <= K)
    if not cfm:
        return blcp._pinned_solve(
            meta, _batched(F), 0.0, _batched(b), _batched(mu), _batched(clamping),
            _batched(upper), _batched(sign_u), None if at_hi is None else _batched(at_hi),
            polish=polish)[:, 0]
    dtype, dev = F.dtype, F.device
    S = clamping.to(dtype)
    _, _, isf, fidx, (lo_rest, hi_rest) = blcp._meta_tensors(meta, dtype, dev)
    isf = isf[:, 0]
    coeff = torch.where(upper, sign_u * mu, torch.zeros_like(mu)) * S[fidx]
    H = F * S[:, None]
    fr = np.where(meta.findex >= 0)[0]
    if len(fr):
        contrib = F * coeff[:, None]
        if blcp._is_contact_layout(meta):
            C3 = int(fr.max()) + 1
            Hn = H[0:C3:3] + contrib[1:C3:3] + contrib[2:C3:3]
            Hc = torch.stack([Hn, H[1:C3:3], H[2:C3:3]], dim=1).reshape(C3, -1)
            H = torch.cat([Hc, H[C3:]])
        else:
            # A friction row adds its coupling to its normal row's H.
            H = H.index_add(0, torch.as_tensor(meta.findex[fr].astype(np.int64), device=dev),
                            contrib[torch.as_tensor(fr, device=dev)])
    z_fixed = None
    if (meta.lo_const is not None or meta.hi_const is not None) and at_hi is not None:
        rest = torch.where(at_hi, hi_rest[:, 0], lo_rest[:, 0])
        z_fixed = torch.where(~clamping & ~isf, rest, torch.zeros_like(rest))
        b = b - _Av(F, cfm, z_fixed)
    # Clamping rows first, in row order: score = clamping 2n - index.
    score = S * (2.0 * n) - torch.arange(n, dtype=dtype, device=dev)
    sel = torch.topk(score, K).indices
    m = S[sel]
    Q = F[sel] @ H[sel].T
    eye = torch.eye(K, dtype=dtype, device=dev)
    # cfm (G P G^T): the gathered P block is diag(c), UPPER_BOUND rows
    # never clamping.
    Q = Q + cfm * eye * m[:, None]
    Qm = m[:, None] * Q * m[None, :] + (eye - m[:, None] * eye)
    zc = _ridge_solve(meta, Qm, b[sel] * m, polish=polish) * m
    z_C = torch.zeros_like(b).scatter(0, sel, zc)
    z = S * z_C + coeff * z_C[fidx]
    return z if z_fixed is None else z + z_fixed


def _pinned_b(meta, F, cfm, b, mu, clamping, upper, sign_u, at_hi=None, polish=True):
    """_pinned_solve in batched/lcp's layout (batch of one), for its
    refinement rounds."""
    return _pinned_solve(meta, F[..., 0], cfm, b[:, 0], mu[:, 0], clamping[:, 0],
                         upper[:, 0], sign_u[:, 0],
                         None if at_hi is None else at_hi[:, 0], polish)[:, None]


def _refine_masks(meta: LcpMeta, F, cfm, b, mu, clamping, upper, sign_u, at_hi):
    """One masked-Dantzig round: solve the active set, then move the rows
    it misclassifies (batched/lcp._refine_masks' rules)."""
    from nimblephysics_tpu_torch.batched import lcp as blcp

    out = blcp._refine_masks(meta, _batched(F), cfm, _batched(b), _batched(mu),
                             _batched(clamping), _batched(upper), _batched(sign_u),
                             _batched(at_hi), pinned=_pinned_b)
    return tuple(x[:, 0] for x in out)


def boxed_lcp(meta: LcpMeta, F, b, mu, z_warm, cfm=0.0, fallback_cfm=1e-4):
    """Solve one world's boxed LCP, A = F F^T + cfm I (the factored
    Delassus operator): F (n, r), b, mu, z_warm (n,) -> z (n,).

    The seed (APGD with its PGS polish, or PGS) runs differentiably; the
    active set is classified and refined on detached values; the pinned
    solve on it carries the gradient (the active-set implicit derivative).
    Where that solve is not a valid solution, the failure ladder takes, in
    order, the seed if it is valid, the cfm-softened pinned solve, the
    normals-only solve, else the seed (BoxedLcpConstraintSolver.cpp:392-646),
    each with its own gradient.
    """
    Fs, bs, mus = F.detach(), b.detach(), mu.detach()
    seed_fn = _apgd if meta.solver == "apgd" else _pgs
    z_seed = seed_fn(meta, F, cfm, b, mu, z_warm)
    if meta.solver == "apgd" and meta.seed_pgs_sweeps:
        z_seed = _pgs(dataclasses.replace(meta, iterations=meta.seed_pgs_sweeps),
                      F, cfm, b, mu, z_seed)
    with torch.no_grad():
        zs = z_seed.detach()
        clamping, upper, at_hi = _classify(meta, Fs, cfm, bs, mus, zs)
        sign_u = torch.sign(zs)
        for _ in range(meta.refine_rounds):
            clamping, upper, sign_u, at_hi = _refine_masks(
                meta, Fs, cfm, bs, mus, clamping, upper, sign_u, at_hi)
    masks = (clamping, upper, sign_u, at_hi)
    z_pol = _pinned_solve(meta, F, cfm, b, mu, *masks)
    with torch.no_grad():
        valid = _lcp_valid(meta, Fs, cfm, bs, mus, z_pol.detach())
        valid_seed = _lcp_valid(meta, Fs, cfm, bs, mus, zs)
    if not fallback_cfm:
        return torch.where(valid, z_pol, z_seed)
    soft = cfm + fallback_cfm
    from nimblephysics_tpu_torch.batched.lcp import _rows

    isf = _rows(meta, F.device)[0][:, 0]
    z_soft = _pinned_solve(meta, F, soft, b, mu, *masks)
    z_nf = _pinned_solve(meta, F, soft, b, mu, clamping & ~isf, torch.zeros_like(upper),
                         sign_u, at_hi)
    z_nf = torch.where(isf, torch.zeros_like(z_nf), z_nf)
    with torch.no_grad():
        valid_soft = _lcp_valid(meta, Fs, soft, bs, mus, z_soft.detach())
        valid_nf = _lcp_valid(meta, Fs, soft, bs, torch.zeros_like(mus), z_nf.detach())
    z_fb = torch.where(valid_seed, z_seed,
                       torch.where(valid_soft, z_soft, torch.where(valid_nf, z_nf, z_seed)))
    return torch.where(valid, z_pol, z_fb)

"""Batched boxed LCP, world batch in the trailing axis.

Counterpart of nimblephysics_tpu/batched/lcp.py: the iterative seed
(batched/lcp_cuda.py: APGD with its optional PGS polish, or PGS alone),
the CLAMPING / UPPER_BOUND / NOT_CLAMPING classification with the
reference tie-breaks, masked-Dantzig refinement rounds, the rank-factored
pinned solve (two r x r SPD solves at cfm = 0, Woodbury at cfm > 0), the
scale-aware validity check and the failure ladder (seed, cfm-softened
pinned solve, ignore-friction rung) with per-world selection, and the
ladder's three gradient rules (fallback_gradients False, True and
"reclassify").

Pinned solve: the clamping block of A P is U V^T with U = S (.) F and
V = S (.) P^T F, rank <= r. Solve U V^T x = S b by x = V alpha with
beta = (U^T U + eps)^-1 U^T b_S and alpha = (V^T V + eps)^-1 beta.

Gradients: what the JAX package stops gradients at (the seed, the masks,
the validity flags, the ladder's output unless fallback_gradients says
otherwise) is computed here under torch.no_grad() and kept in an
LcpSaved; only the pinned solves (and, for the fallback gradients, the
pieces they differentiate) carry the graph. Handing the LcpSaved back in
(`saved=`) replays just those pieces: the analog of LCP_REMAT_POLICY,
with which a checkpointed step's recompute never re-runs the seed, the
kernel, the refine rounds or the ladder.

Shapes: F (n, r, B), b/mu/z (n, B).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.batched import linalg as bl
from nimblephysics_tpu_torch.constraint.lcp import LcpMeta, _dtype_ridge, _dtype_tol


@functools.lru_cache(maxsize=64)
def _meta_tensors(meta: LcpMeta, dtype: torch.dtype, device: torch.device):
    """The row plan's static tensors, built once per meta/dtype/device so
    that a step copies nothing from the host: bounds lo/hi (n, 1),
    is_friction (n, 1) bool, findex clamped to >= 0 (the gather index of
    every row; non-friction rows gather row 0) and the bounds with the
    infinite ones at 0 (n, 1), where a pinned row rests."""
    n = meta.n
    lo = (
        torch.as_tensor(meta.lo_const, dtype=dtype, device=device)
        if meta.lo_const is not None
        else torch.zeros(n, dtype=dtype, device=device)
    )
    hi = (
        torch.as_tensor(meta.hi_const, dtype=dtype, device=device)
        if meta.hi_const is not None
        else torch.full((n,), float("inf"), dtype=dtype, device=device)
    )
    isf = torch.as_tensor(np.asarray(meta.is_friction), device=device)[:, None]
    fidx = torch.as_tensor(
        np.maximum(meta.findex, 0).astype(np.int64), device=device
    )
    lo, hi = lo[:, None], hi[:, None]
    zero = torch.zeros_like(lo)
    rest = (torch.where(torch.isfinite(lo), lo, zero),
            torch.where(torch.isfinite(hi), hi, zero))
    return lo, hi, isf, fidx, rest


def _const_bounds(meta: LcpMeta, dtype, device):
    lo, hi, _, _, _ = _meta_tensors(meta, dtype, torch.device(device))
    return lo, hi


def _rows(meta: LcpMeta, device):
    """is_friction (n, 1) bool and the clamped findex gather index."""
    _, _, isf, fidx, _ = _meta_tensors(meta, torch.float32, torch.device(device))
    return isf, fidx


def _Av(F, cfm, y):
    """A y = F (F^T y) + cfm y; F (n, r, B), y (n, B)."""
    u = torch.sum(F * y[:, None, :], dim=0)  # (r, B)
    return torch.sum(F * u[None, :, :], dim=1) + cfm * y


def _diag_A(F, cfm):
    return torch.sum(F * F, dim=1) + cfm  # (n, B)


def _classify(meta: LcpMeta, F, cfm, b, mu, z):
    """Same tie-break rules as constraint/lcp._classify, trailing batch."""
    tol = _dtype_tol(meta, z.dtype)
    w = _Av(F, cfm, z) - b
    isf, fidx = _rows(meta, z.device)
    bound = mu * z[fidx]
    degenerate = _diag_A(F, cfm) < 1e-9
    lo_c, hi_c = _const_bounds(meta, z.dtype, z.device)

    inside = (z > lo_c + tol) & (z < hi_c - tol)
    n_clamp = inside | (torch.abs(w) < tol)
    at_hi = (~n_clamp) & (z >= hi_c - tol) & torch.isfinite(hi_c)
    no_normal = bound <= tol
    at_bound = (~no_normal) & (torch.abs(z) >= bound - tol)
    f_clamp = (~no_normal) & (~at_bound)

    clamping = torch.where(isf, f_clamp, n_clamp) & ~degenerate
    upper = isf & at_bound & ~degenerate
    at_hi = ~isf & at_hi & ~degenerate
    return clamping, upper, at_hi


@functools.lru_cache(maxsize=64)
def _is_contact_layout(meta: LcpMeta) -> bool:
    """Friction rows are exactly [3c+1, 3c+2] -> normal 3c for a prefix of
    contact triples (the assembler's layout)."""
    fidx_np = np.maximum(meta.findex, 0)
    fr = np.where(meta.findex >= 0)[0]
    C3 = int(fr.max()) + 1
    return bool(
        C3 % 3 == 0
        and np.array_equal(fr, np.setdiff1d(np.arange(C3), np.arange(0, C3, 3)))
        and np.array_equal(fidx_np[fr].reshape(-1, 2).T[0], np.arange(0, C3, 3))
        and np.array_equal(fidx_np[fr].reshape(-1, 2).T[1], np.arange(0, C3, 3))
    )


def _build_UV(meta: LcpMeta, F, mu, clamping, upper, sign_u):
    """U = S (.) F and V = S (.) P^T F for the pinned clamping system."""
    S = clamping.to(F.dtype)  # (n, B)
    _, fidx = _rows(meta, F.device)
    coeff = torch.where(upper, sign_u * mu, torch.zeros_like(mu)) * S[fidx]

    H = F * S[:, None, :]
    fr = np.where(meta.findex >= 0)[0]
    if len(fr) > 0:
        if not _is_contact_layout(meta):
            # The assembler puts its contact triples first, and islands and
            # the contact cap keep them so; only a hand-made plan gets here.
            raise NotImplementedError(
                "pinned solve: friction rows outside the contact-triple "
                "layout (no world the assembler builds has them)"
            )
        contrib = F * coeff[:, None, :]
        C3 = int(fr.max()) + 1
        Hn = H[0:C3:3] + contrib[1:C3:3] + contrib[2:C3:3]
        Hc = torch.stack([Hn, H[1:C3:3], H[2:C3:3]], dim=1).reshape(
            (C3,) + tuple(H.shape[1:])
        )
        H = torch.cat([Hc, H[C3:]], dim=0)
    U = F * S[:, None, :]
    return U, H, S, coeff


def _pinned_solve(
    meta: LcpMeta, F, cfm, b, mu, clamping, upper, sign_u, at_hi=None,
    polish: bool = True,
):
    """Exact solve of the pinned active set (rank-factored).

    cfm = 0: x = V alpha from the two ridged r x r normal-equation solves.
    cfm > 0 (the ladder rung): (U V^T + cfm I)|_S x = rhs by Woodbury,
    x = (rhs - U w)/cfm with (cfm I_r + V^T U) w = V^T rhs solved through
    ridged normal equations.

    With box bounds (meta.lo_const / hi_const), a non-friction row that
    does not clamp rests at its upper bound where at_hi says so, else at
    its lower bound (an infinite bound at 0): that fixed z enters the
    right-hand side, b - A z_fixed, and the result.
    """
    dtype = F.dtype
    r = F.shape[1]
    U, H, S, coeff = _build_UV(meta, F, mu, clamping, upper, sign_u)
    _, _, isf, fidx, (lo_rest, hi_rest) = _meta_tensors(meta, dtype, F.device)

    z_fixed = None
    if (meta.lo_const is not None or meta.hi_const is not None) and at_hi is not None:
        z_fixed = torch.where(~clamping & ~isf, torch.where(at_hi, hi_rest, lo_rest),
                              torch.zeros_like(b))
        b = b - _Av(F, cfm, z_fixed)
    bS = b * S
    ridge = _dtype_ridge(meta, dtype)
    eye_r = torch.eye(r, dtype=dtype, device=F.device)[..., None]

    def spd_factor(P):
        """Guarded Cholesky of P + ridge (tr P / r + 1) I, factored once
        and reused by the polish solve."""
        tr = torch.diagonal(P, dim1=0, dim2=1).sum(-1)  # (B,)
        eps = ridge * (tr / r + 1.0)
        return bl.cholesky(P + eps[None, None, :] * eye_r)

    def spd_solve(Lf, rhs):
        return bl.solve_tri_upper_t_vec(Lf, bl.solve_tri_lower_vec(Lf, rhs))

    if cfm:
        K = cfm * eye_r + bl.gram(H, U)  # (r, r, B) = cfm I + V^T U
        L_K = spd_factor(torch.sum(K[:, :, None, :] * K[:, None, :, :], dim=0))

        def solve_once(rhs_S):
            Vt_rhs = torch.sum(H * rhs_S[:, None, :], dim=0)  # (r, B)
            Kt_rhs = torch.sum(K * Vt_rhs[:, None, :], dim=0)
            w = spd_solve(L_K, Kt_rhs)
            x = (rhs_S - torch.sum(U * w[None, :, :], dim=1)) / cfm
            return x * S
    else:
        L_1 = spd_factor(bl.gram(U, U))
        L_2 = spd_factor(bl.gram(H, H))

        def solve_once(rhs_S):
            Ut_rhs = torch.sum(U * rhs_S[:, None, :], dim=0)  # (r, B)
            alpha = spd_solve(L_2, spd_solve(L_1, Ut_rhs))
            return torch.sum(H * alpha[None, :, :], dim=1)  # x = V alpha

    x = solve_once(bS)
    if polish:
        # One iterative-refinement step cancels the ridge bias.
        x = x + solve_once(bS - _UVt(U, H, x))
    z = S * x + coeff * x[fidx]
    return z if z_fixed is None else z + z_fixed


def _UVt(U, V, x):
    """(U V^T) x for skinny U, V (n, r, B), x (n, B)."""
    u = torch.sum(V * x[:, None, :], dim=0)
    return torch.sum(U * u[None, :, :], dim=1)


def _refine_masks(meta: LcpMeta, F, cfm, b, mu, clamping, upper, sign_u, at_hi):
    """Masked-Dantzig refinement round (parity with constraint/lcp)."""
    tol = _dtype_tol(meta, F.dtype)
    z = _pinned_solve(
        meta, F, cfm, b, mu, clamping, upper, sign_u, at_hi=at_hi,
        polish=False,
    )
    w = _Av(F, cfm, z) - b
    isf, fidx = _rows(meta, F.device)
    bound = mu * torch.clamp(z[fidx], min=0.0)
    degenerate = _diag_A(F, cfm) < 1e-9
    lo_c, hi_c = _const_bounds(meta, F.dtype, F.device)
    fin_hi = torch.isfinite(hi_c)

    went_over = clamping & (z > hi_c + tol) & fin_hi
    n_clamp = torch.where(
        clamping,
        (z > lo_c - tol) & ~went_over,
        torch.where(at_hi, w > tol, w < -tol),
    )
    at_hi2 = torch.where(clamping, went_over, at_hi & (w <= tol)) & fin_hi
    no_normal = bound <= tol
    over = torch.abs(z) > bound + tol
    new_sign = torch.where(torch.abs(z) > tol, torch.sign(z), sign_u)
    ub_consistent = torch.where(sign_u > 0, w <= tol, w >= -tol)
    f_clamp = torch.where(upper, ~ub_consistent & ~no_normal, ~over & ~no_normal)
    f_upper = torch.where(upper, ub_consistent & ~no_normal, over & ~no_normal)
    clamping2 = torch.where(isf, f_clamp, n_clamp) & ~degenerate
    upper2 = isf & f_upper & ~degenerate
    at_hi2 = ~isf & at_hi2 & ~degenerate
    return clamping2, upper2, new_sign, at_hi2


def _lcp_valid(meta: LcpMeta, F, cfm, b, mu, z):
    """Scale-aware boxed-LCP validity, per world (B,) bool."""
    w = _Av(F, cfm, z) - b
    isf, fidx = _rows(meta, z.device)
    bound = mu * z[fidx]
    tol = max(1e-7, 1000.0 * float(torch.finfo(z.dtype).eps))
    scale_w = 1.0 + torch.amax(torch.abs(b), dim=0, keepdim=True)
    scale_z = 1.0 + torch.amax(torch.abs(z), dim=0, keepdim=True)
    lo_c, hi_c = _const_bounds(meta, z.dtype, z.device)
    near_hi = (z >= hi_c - tol * scale_z) & torch.isfinite(hi_c)
    ok_n = isf | (
        (z >= lo_c - tol * scale_z)
        & (z <= hi_c + tol * scale_z)
        & (near_hi | (w >= -10 * tol * scale_w))
    )
    ok_f = ~isf | (torch.abs(z) <= bound + tol * scale_z)
    finite = torch.all(torch.isfinite(z), dim=0)
    return torch.all(ok_n & ok_f, dim=0) & finite


class LcpSaved(NamedTuple):
    """What boxed_lcp_b decides without gradients, all detached: enough to
    replay its differentiable part on the same inputs."""

    z_seed: torch.Tensor  # (n, B) the seed's value
    z_kernel: Optional[torch.Tensor]  # (n, B) on the card, the kernel's output
    clamping: torch.Tensor  # (n, B) bool, the refined active set ...
    upper: torch.Tensor
    sign_u: torch.Tensor
    at_hi: torch.Tensor
    valid: torch.Tensor  # (B,) bool: the pinned solve is valid
    z_fb: torch.Tensor  # (n, B) the ladder's output where it is not valid
    # Kept for the fallback gradients only (None otherwise):
    z_ladder: Optional[torch.Tensor] = None  # the rungs' output before the lazy select
    all_ok: Optional[torch.Tensor] = None  # () bool: every world valid or seed-valid
    valid_seed: Optional[torch.Tensor] = None  # (B,) bool, per rung ...
    valid_soft: Optional[torch.Tensor] = None
    valid_nf: Optional[torch.Tensor] = None
    reclassified: Optional[Tuple[torch.Tensor, ...]] = None  # ladder output's masks


def _seed(meta: LcpMeta, F, b, mu, z_warm, cfm, z_kernel=None):
    """The iterative seed, and on the card the kernel's raw output (None
    elsewhere): APGD (kernel K1/K1b on the card) or, for solver "pgs",
    meta.iterations sweeps of PGS (no kernel in either package)."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    if meta.solver == "pgs":
        return lcp_cuda.pgs_plain(meta, F, cfm, b, mu, z_warm), None
    if F.device.type == "cuda" and z_kernel is None:
        z_kernel = lcp_cuda.seed_kernel(meta, F, b, mu, z_warm, cfm)
    return lcp_cuda.apgd_seed(meta, F, b, mu, z_warm, cfm, z_kernel=z_kernel), z_kernel


def _soft_rungs(meta: LcpMeta, F, soft, b, mu, masks):
    """The ladder's cfm-softened pinned solve and its ignore-friction rung
    (friction rows neither clamp nor carry impulse)."""
    clamping, upper, sign_u, at_hi = masks
    isf, _ = _rows(meta, F.device)
    z_soft = _pinned_solve(meta, F, soft, b, mu, *masks)
    z_nf = _pinned_solve(meta, F, soft, b, mu, clamping & ~isf,
                         torch.zeros_like(upper), sign_u, at_hi)
    return z_soft, torch.where(isf, torch.zeros_like(z_nf), z_nf)


def _pick_rung(valid_seed, valid_soft, valid_nf, z_seed, z_soft, z_nf):
    """Per world, the first valid of seed, softened solve and
    ignore-friction rung, else the seed (the reference's ladder order)."""
    return torch.where(
        valid_seed[None, :],
        z_seed,
        torch.where(
            valid_soft[None, :],
            z_soft,
            torch.where(valid_nf[None, :], z_nf, z_seed),
        ),
    )


@torch.no_grad()
def _ladder(meta: LcpMeta, F, b, mu, cfm, fallback_cfm, fallback_gradients,
            ladder_mode, z_seed, z_kernel, masks, z_pol) -> LcpSaved:
    """Validity of the pinned solve, the failure ladder's rungs and the
    impulse they give each world (BoxedLcpConstraintSolver.cpp:392-646)."""
    valid = _lcp_valid(meta, F, cfm, b, mu, z_pol)
    valid_seed = _lcp_valid(meta, F, cfm, b, mu, z_seed)
    all_ok = torch.all(valid | valid_seed)
    z_ladder = valid_soft = valid_nf = reclassified = None
    if fallback_cfm:
        soft = cfm + fallback_cfm
        z_soft, z_nf = _soft_rungs(meta, F, soft, b, mu, masks)
        valid_soft = _lcp_valid(meta, F, soft, b, mu, z_soft)
        valid_nf = _lcp_valid(meta, F, soft, b, torch.zeros_like(mu), z_nf)
        z_ladder = _pick_rung(valid_seed, valid_soft, valid_nf, z_seed, z_soft, z_nf)
        # "lazy" runs the rungs only when some world has neither a valid
        # pinned solve nor a valid seed; selecting the seed when none
        # does gives the same values and gradients with no host sync.
        z_fb = (
            torch.where(all_ok, z_seed, z_ladder) if ladder_mode == "lazy" else z_ladder
        )
        if fallback_gradients == "reclassify":
            # Classify the ladder's impulse (mu = 0 for worlds that fell
            # to the ignore-friction rung), as the reference builds its
            # gradient matrices from the ladder's mX.
            mu_cls = torch.where(valid_soft[None, :], mu, torch.zeros_like(mu))
            c2, u2, hi2 = _classify(meta, F, soft, b, mu_cls, z_ladder)
            reclassified = (c2, u2, torch.sign(z_ladder), hi2)
    else:
        z_fb = z_seed
    if not fallback_gradients:
        z_ladder = all_ok = valid_seed = valid_soft = valid_nf = None
    return LcpSaved(
        z_seed, z_kernel, *masks, valid, z_fb, z_ladder, all_ok, valid_seed,
        valid_soft, valid_nf, reclassified,
    )


def _fallback_with_gradients(meta: LcpMeta, F, b, mu, cfm, fallback_cfm,
                             fallback_gradients, ladder_mode, z_seed,
                             s: LcpSaved):
    """The ladder's output with the gradients fallback_gradients asks for:
    True differentiates the rungs themselves, "reclassify" one pinned
    solve with the softened cfm on the masks of the ladder's impulse."""
    if not fallback_cfm:
        return z_seed
    soft = cfm + fallback_cfm
    if fallback_gradients == "reclassify":
        mu_g = torch.where(s.valid_soft[None, :], mu, mu.detach())
        z_grad = _pinned_solve(meta, F, soft, b, mu_g, *s.reclassified)
        z_lad = s.z_ladder + (z_grad - z_grad.detach())
    else:
        masks = (s.clamping, s.upper, s.sign_u, s.at_hi)
        z_lad = _pick_rung(s.valid_seed, s.valid_soft, s.valid_nf, z_seed,
                           *_soft_rungs(meta, F, soft, b, mu, masks))
    return torch.where(s.all_ok, z_seed, z_lad) if ladder_mode == "lazy" else z_lad


def boxed_lcp_b(meta: LcpMeta, F, b, mu, z_warm, cfm=0.0, fallback_cfm=1e-4,
                fallback_gradients=False, ladder_mode="lazy",
                saved: Optional[LcpSaved] = None, return_saved: bool = False):
    """Batched boxed LCP solve with the CFM-softened / ignore-friction
    failure ladder (BoxedLcpConstraintSolver.cpp:392-646 parity).

    The ladder rungs always run, with per-world selection, whatever
    `ladder_mode` says: the forward values of the JAX package's "lazy"
    mode (rungs behind a cond on "any world invalid") are the same, and
    the cond would cost a device-to-host sync per step here. Where the
    lazy cond would not fire, "lazy" selects the seed as the JAX package
    does, so the fallback gradients follow it too.

    fallback_gradients: False gives ladder-resolved worlds no impulse
    gradient (the JAX package's default); "reclassify" differentiates one
    softened pinned solve on the masks of the ladder's impulse; True
    differentiates the rungs (and the seed) themselves.

    saved: the LcpSaved of an earlier call with return_saved=True on the
    same inputs. The call then runs only the differentiable pinned
    solve(s) (and, for the fallback gradients, the seed's differentiable
    part) on the saved masks: same values, same gradients, no seed and no
    kernel launch.

    Args: F (n, r, B), b/mu/z_warm (n, B). Returns z (n, B), or
    (z, LcpSaved) with return_saved=True.
    """
    if ladder_mode not in ("lazy", "always"):
        raise ValueError(f"unknown ladder_mode {ladder_mode!r}")
    if fallback_gradients not in (False, True, "reclassify"):
        raise ValueError(f"unknown fallback_gradients {fallback_gradients!r}")
    if meta.solver not in ("apgd", "pgs"):
        raise ValueError(f"unknown LCP solver {meta.solver!r}")
    z_seed = None
    if fallback_gradients:
        z_seed, z_kernel = _seed(
            meta, F, b, mu, z_warm, cfm, None if saved is None else saved.z_kernel
        )
    if saved is None:
        Fs, bs, mus = F.detach(), b.detach(), mu.detach()
        with torch.no_grad():
            if z_seed is None:
                z_seed, z_kernel = _seed(meta, Fs, bs, mus, z_warm.detach(), cfm)
            zs = z_seed.detach()
            clamping, upper, at_hi = _classify(meta, Fs, cfm, bs, mus, zs)
            sign_u = torch.sign(zs)
            for _ in range(meta.refine_rounds):
                clamping, upper, sign_u, at_hi = _refine_masks(
                    meta, Fs, cfm, bs, mus, clamping, upper, sign_u, at_hi
                )
        masks = (clamping, upper, sign_u, at_hi)
    else:
        masks = (saved.clamping, saved.upper, saved.sign_u, saved.at_hi)
    z_pol = _pinned_solve(meta, F, cfm, b, mu, *masks)
    if saved is None:
        saved = _ladder(
            meta, Fs, bs, mus, cfm, fallback_cfm, fallback_gradients,
            ladder_mode, zs, z_kernel, masks, z_pol.detach(),
        )
    if fallback_gradients:
        z_fb = _fallback_with_gradients(
            meta, F, b, mu, cfm, fallback_cfm, fallback_gradients,
            ladder_mode, z_seed, saved,
        )
    else:
        z_fb = saved.z_fb
    z = torch.where(saved.valid[None, :], z_pol, z_fb)
    return (z, saved) if return_saved else z

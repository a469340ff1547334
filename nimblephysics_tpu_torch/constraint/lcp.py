"""Static row metadata of the boxed LCP and its dtype-aware tolerances.

Counterpart of LcpMeta, subset_meta, _dtype_tol and _dtype_ridge in
nimblephysics_tpu/constraint/lcp.py. The batched solver itself is
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

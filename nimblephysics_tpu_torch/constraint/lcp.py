"""Static row metadata of the boxed LCP and its dtype-aware tolerances.

Counterpart of LcpMeta, _dtype_tol and _dtype_ridge in
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


def _dtype_tol(meta: LcpMeta, dtype: torch.dtype) -> float:
    return max(meta.tol, 100.0 * float(torch.finfo(dtype).eps))


def _dtype_ridge(meta: LcpMeta, dtype: torch.dtype) -> float:
    return max(meta.ridge, 50.0 * float(torch.finfo(dtype).eps))

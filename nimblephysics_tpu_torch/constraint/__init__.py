"""Constraint row plan and LCP metadata."""

from nimblephysics_tpu_torch.constraint.assembly import ConstraintAssembler
from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

"""Signed distance queries between a world's shapes.

Counterpart of nimblephysics_tpu/collision/distance.py: the same
narrowphase as the contacts, distance = -depth of every candidate slot
(negative when penetrating), differentiable in q.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nimblephysics_tpu_torch.collision.collider import Collider
from nimblephysics_tpu_torch.simulation.world import World


class DistanceResult(NamedTuple):
    """The nearest slot (reference: collision::DistanceResult)."""

    min_distance: torch.Tensor  # signed: negative = penetrating
    point: torch.Tensor  # (3,) the slot's contact point
    normal: torch.Tensor  # (3,) from body B to body A
    pair_index: torch.Tensor  # int64 index into the collider's contact slots


def distance(world: World, q: torch.Tensor,
             collider: Optional[Collider] = None) -> DistanceResult:
    """The minimum signed distance over every candidate contact slot."""
    contacts = (collider or Collider(world)).collide(q)
    sd = -contacts.depth
    k = torch.argmin(sd)
    return DistanceResult(sd[k], contacts.point[k], contacts.normal[k], k)


def pairwise_distances(world: World, q: torch.Tensor,
                       collider: Optional[Collider] = None) -> torch.Tensor:
    """The signed distance of every candidate contact slot, (C,)."""
    return -(collider or Collider(world)).collide(q).depth

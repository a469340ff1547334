"""Collider: the static shape-pair slot plan of a World.

Counterpart of the plan half of nimblephysics_tpu/collision/collider.py
(_PairSlot, _canonical_pair, the BodyNodeCollisionFilter rules of
Collider._build and num_contacts). Pairs are enumerated once from the
static world spec; batched/collision.py evaluates them.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from nimblephysics_tpu_torch.dynamics import shapes as SH
from nimblephysics_tpu_torch.simulation.world import World


@dataclasses.dataclass(frozen=True)
class _PairSlot:
    kind: str  # narrowphase dispatch key
    body_a: int
    body_b: int
    shape_a: SH.ShapeSpec
    shape_b: SH.ShapeSpec
    n_slots: int


# (type_a, type_b) -> (kind, contact slots per pair); ellipsoids collide
# as spheres (reference behaviour).
_PAIR_TABLE = {
    (SH.SPHERE, SH.SPHERE): ("sphere_sphere", 1),
    (SH.SPHERE, SH.PLANE): ("sphere_plane", 1),
    (SH.BOX, SH.PLANE): ("box_plane", 8),
    (SH.SPHERE, SH.BOX): ("sphere_box", 1),
    (SH.CAPSULE, SH.PLANE): ("capsule_plane", 2),
    (SH.CAPSULE, SH.SPHERE): ("capsule_sphere", 1),
    (SH.CAPSULE, SH.CAPSULE): ("capsule_capsule", 1),
    (SH.CAPSULE, SH.BOX): ("capsule_box", 3),
    (SH.BOX, SH.BOX): ("box_box", 8),
}

# Pairs the JAX package collides through convex hulls, heightmaps or
# sphere sets; their slot counts depend on that geometry.
_LATER_TYPES = (SH.MESH, SH.HEIGHTMAP, SH.MULTI_SPHERE)


def _canonical_pair(sa: SH.ShapeSpec, sb: SH.ShapeSpec):
    """Order a shape pair into a supported canonical (kind, n, swap)."""
    norm = {SH.ELLIPSOID: SH.SPHERE}
    ta = norm.get(sa.shape_type, sa.shape_type)
    tb = norm.get(sb.shape_type, sb.shape_type)
    if (ta, tb) in _PAIR_TABLE:
        return _PAIR_TABLE[(ta, tb)] + (False,)
    if (tb, ta) in _PAIR_TABLE:
        return _PAIR_TABLE[(tb, ta)] + (True,)
    if ta in _LATER_TYPES or tb in _LATER_TYPES:
        raise NotImplementedError(
            f"collision pair ({ta}, {tb}): mesh, heightmap and multisphere "
            "kinds come with the rest of the batched engine (ROADMAP queue 1 "
            "item 9)"
        )
    return None, 0, False


def _sphere_radius(spec: SH.ShapeSpec) -> float:
    if spec.shape_type == SH.ELLIPSOID:
        return float(np.mean(np.asarray(spec.size)) / 2.0)
    return float(np.asarray(spec.size).reshape(-1)[0])


class Collider:
    """Static collision plan for a World."""

    def __init__(self, world: World):
        self.world = world
        self.slots: List[_PairSlot] = []
        self._build()

    def _build(self) -> None:
        w = self.world
        body_off = w.body_offsets()
        entries = []
        for si, skel in enumerate(w.skeletons):
            for bi, body in enumerate(skel.bodies):
                for shape in body.shapes:
                    if shape.collidable:
                        entries.append((body_off[si] + bi, si, bi, shape))

        def filtered(ga, si_a, bi_a, gb, si_b, bi_b) -> bool:
            """BodyNodeCollisionFilter parity (CollisionFilter.hpp:91-111):
            explicit overrides win; same-skeleton pairs are skipped unless
            the skeleton enables self-collision, and joint-adjacent pairs
            also need the adjacent-body check."""
            key = (min(ga, gb), max(ga, gb))
            if key in w.collision_overrides:
                return not w.collision_overrides[key]
            if si_a != si_b:
                return False
            if bi_a == bi_b:
                return True
            skel = w.skeletons[si_a]
            if not skel.self_collision_enabled:
                return True
            ja = skel.joints
            adjacent = ja[bi_a].parent == bi_b or ja[bi_b].parent == bi_a
            return adjacent and not skel.adjacent_body_check

        def is_static(si) -> bool:
            return w.skeletons[si].num_dofs == 0

        for i in range(len(entries)):
            for j in range(i + 1, len(entries)):
                ga, sa_i, ba_i, sa = entries[i]
                gb, sb_i, bb_i, sb = entries[j]
                if filtered(ga, sa_i, ba_i, gb, sb_i, bb_i):
                    continue
                if is_static(sa_i) and is_static(sb_i):
                    continue
                kind, n_slots, swap = _canonical_pair(sa, sb)
                if kind is None:
                    continue
                if swap:
                    ga, gb, sa, sb = gb, ga, sb, sa
                self.slots.append(_PairSlot(kind, ga, gb, sa, sb, n_slots))

    @property
    def num_contacts(self) -> int:
        n = sum(s.n_slots for s in self.slots)
        if self.world.max_contacts is not None:
            return min(n, self.world.max_contacts)
        return n

"""Collider: the static shape-pair slot plan of a World, and the contact
set of one world.

Counterpart of nimblephysics_tpu/collision/collider.py (_PairSlot,
_canonical_pair, the BodyNodeCollisionFilter rules of Collider._build,
num_contacts, Contacts and Collider.collide). Pairs are enumerated once
from the static world spec; batched/collision.py evaluates them on a
world batch, `collide` on one world through narrowphase.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.dynamics import shapes as SH
from nimblephysics_tpu_torch.simulation.world import World


class Contacts(NamedTuple):
    """The fixed-size contact set of one world (every array has the slot
    count C first). The normal points from body B to body A; a slot with
    depth <= 0 is empty."""

    point: torch.Tensor  # (C, 3) world
    normal: torch.Tensor  # (C, 3) world, unit, B -> A
    depth: torch.Tensor  # (C,) penetration (> 0 = touching)
    body_a: torch.Tensor  # (C,) int64 global body index
    body_b: torch.Tensor  # (C,)
    friction: torch.Tensor  # (C,) combined mu (the smaller)
    restitution: torch.Tensor  # (C,) combined e (the product)

    @property
    def count(self) -> int:
        return self.point.shape[-2]

    def valid_mask(self) -> torch.Tensor:
        return self.depth > 0.0


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
            "pairs go through the convex-hull, heightmap and sphere-set "
            "narrowphase, which comes with ROADMAP queue 1 item 10c"
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
        self._tensors: Dict[Tuple, dict] = {}

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

    def check_uncapped(self) -> None:
        """Raise where World.max_contacts is below the slot count: the JAX
        collider caps num_contacts but returns every slot, and the port
        waits for a reference test that pins its meaning (ROADMAP queue 3,
        known differences)."""
        if self.num_contacts != sum(s.n_slots for s in self.slots):
            raise NotImplementedError(
                "World.max_contacts below the slot count: the JAX collider "
                "caps num_contacts but returns every slot; the port waits for "
                "a reference test that pins its meaning (ROADMAP queue 3, "
                "known differences)"
            )

    def _consts(self, dtype, device) -> dict:
        """Each slot's shape offsets and sizes, and the contacts' static
        columns, as tensors, built once per dtype and device."""
        key = (dtype, torch.device(device))
        if key not in self._tensors:
            def t(x):
                return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                                       device=device)

            slots = []
            for s in self.slots:
                c = dict(T_a=t(s.shape_a.T_offset), T_b=t(s.shape_b.T_offset))
                for side, spec in (("a", s.shape_a), ("b", s.shape_b)):
                    size = np.asarray(spec.size, dtype=np.float64).reshape(-1)
                    if spec.shape_type == SH.PLANE:
                        c["n_local"] = t(size[:3] / np.linalg.norm(size[:3]))
                        c["d_local"] = t(size[3] if size.size > 3 else 0.0)
                    elif spec.shape_type == SH.BOX:
                        c[f"half_{side}"] = t(size / 2.0)
                    elif spec.shape_type == SH.CAPSULE:
                        c[f"radius_{side}"], c[f"height_{side}"] = t(size[0]), t(size[1])
                    else:
                        c[f"radius_{side}"] = t(_sphere_radius(spec))
                slots.append(c)
            k = [s.n_slots for s in self.slots]

            def per_contact(vals, kind):
                return torch.as_tensor(np.repeat(np.asarray(vals, dtype=kind), k),
                                       device=device)

            self._tensors[key] = dict(
                slots=slots,
                body_a=per_contact([s.body_a for s in self.slots], np.int64),
                body_b=per_contact([s.body_b for s in self.slots], np.int64),
                friction=per_contact([min(s.shape_a.friction, s.shape_b.friction)
                                      for s in self.slots], np.float64).to(dtype),
                restitution=per_contact([s.shape_a.restitution * s.shape_b.restitution
                                         for s in self.slots], np.float64).to(dtype),
            )
        return self._tensors[key]

    def collide(self, q: torch.Tensor, T_wb: Optional[torch.Tensor] = None) -> Contacts:
        """Every slot's narrowphase test at q: the fixed-size contact set,
        differentiable in q (points, normals and depths carry their
        gradients). T_wb: the bodies' world transforms (NB, 4, 4) when
        already computed, else world_fk(q)."""
        self.check_uncapped()
        dtype, device = q.dtype, q.device
        if T_wb is None:
            from nimblephysics_tpu_torch.simulation.world import world_fk

            T_wb = world_fk(self.world, q)
        c = self._consts(dtype, device)
        if not self.slots:
            z3 = torch.zeros(0, 3, dtype=dtype, device=device)
            z1 = torch.zeros(0, dtype=dtype, device=device)
            zi = torch.zeros(0, dtype=torch.int64, device=device)
            return Contacts(z3, z3, z1, zi, zi, z1, z1)
        pts, nrm, dep = [], [], []
        for slot, sc in zip(self.slots, c["slots"]):
            Ta = T_wb[slot.body_a] @ sc["T_a"]
            Tb = T_wb[slot.body_b] @ sc["T_b"]
            p, n, d = self._dispatch(slot, Ta, Tb, sc)
            pts.append(p)
            nrm.append(n)
            dep.append(d)
        return Contacts(torch.cat(pts), torch.cat(nrm), torch.cat(dep), c["body_a"],
                        c["body_b"], c["friction"], c["restitution"])

    @staticmethod
    def _dispatch(slot: _PairSlot, Ta, Tb, c):
        """One slot's narrowphase test; c: the slot's constants
        (_consts)."""
        from nimblephysics_tpu_torch.collision import narrowphase as nphase

        k = slot.kind
        if k == "sphere_sphere":
            return nphase.sphere_sphere(Ta[:3, 3], c["radius_a"], Tb[:3, 3], c["radius_b"])
        if k == "sphere_box":
            return nphase.sphere_box(Ta[:3, 3], c["radius_a"], Tb, c["half_b"])
        if k == "capsule_sphere":
            return nphase.capsule_sphere(Ta, c["radius_a"], c["height_a"], Tb[:3, 3],
                                         c["radius_b"])
        if k == "capsule_capsule":
            return nphase.capsule_capsule(Ta, c["radius_a"], c["height_a"], Tb,
                                          c["radius_b"], c["height_b"])
        if k == "capsule_box":
            return nphase.capsule_box(Ta, c["radius_a"], c["height_a"], Tb, c["half_b"])
        if k == "box_box":
            return nphase.box_box_sat(Ta, c["half_a"], Tb, c["half_b"])
        # The plane kinds: the plane in world coordinates.
        n_w = Tb[:3, :3] @ c["n_local"]
        d_w = c["d_local"] + torch.dot(n_w, Tb[:3, 3])
        if k == "sphere_plane":
            return nphase.sphere_plane(Ta[:3, 3], c["radius_a"], n_w, d_w)
        if k == "box_plane":
            return nphase.box_plane(Ta, c["half_a"], n_w, d_w)
        if k == "capsule_plane":
            return nphase.capsule_plane(Ta, c["radius_a"], c["height_a"], n_w, d_w)
        raise NotImplementedError(k)

"""Collider: the static shape-pair slot plan of a World, and the contact
set of one world.

Counterpart of nimblephysics_tpu/collision/collider.py (_PairSlot,
_canonical_pair, the BodyNodeCollisionFilter rules of Collider._build,
num_contacts, Contacts, Collider.collide and _dispatch_multisphere).
Pairs are enumerated once from the static world spec, with every pair
kind of the JAX package: the primitive pairs, convex meshes (hulls built
here), heightmaps and sphere sets. Each slot runs one or more primitive
test units (a sphere set one per member sphere); batched/collision.py
evaluates them on a world batch, `collide` on one world through
narrowphase.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.collision.convex import ConvexHull
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
    hull_a: object = None  # convex.ConvexHull of a mesh shape
    hull_b: object = None
    flip: bool = False  # a test unit whose normal is negated (see _units)


# (type_a, type_b) -> (kind, contact slots per pair); ellipsoids collide
# as spheres (reference behaviour). A mesh pair's slot count follows its
# decimated hull and a sphere set's its spheres (Collider._build).
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
    # Convex meshes (collision/convex.py).
    (SH.MESH, SH.PLANE): ("mesh_plane", 8),
    (SH.SPHERE, SH.MESH): ("sphere_mesh", 1),
    (SH.CAPSULE, SH.MESH): ("capsule_mesh", 3),
    (SH.BOX, SH.MESH): ("box_mesh", 8),
    (SH.MESH, SH.MESH): ("mesh_mesh", 8),
    # Heightmap terrain.
    (SH.SPHERE, SH.HEIGHTMAP): ("sphere_heightmap", 1),
    (SH.CAPSULE, SH.HEIGHTMAP): ("capsule_heightmap", 3),
    (SH.BOX, SH.HEIGHTMAP): ("box_heightmap", 8),
    # Sphere sets collide as their member spheres.
    (SH.MULTI_SPHERE, SH.PLANE): ("multisphere_plane", 0),
    (SH.SPHERE, SH.MULTI_SPHERE): ("sphere_multisphere", 0),
    (SH.CAPSULE, SH.MULTI_SPHERE): ("capsule_multisphere", 0),
    (SH.BOX, SH.MULTI_SPHERE): ("box_multisphere", 0),
    (SH.MULTI_SPHERE, SH.MULTI_SPHERE): ("multisphere_multisphere", 0),
    (SH.MULTI_SPHERE, SH.HEIGHTMAP): ("multisphere_heightmap", 0),
}


def _canonical_pair(sa: SH.ShapeSpec, sb: SH.ShapeSpec):
    """Order a shape pair into a supported canonical (kind, n, swap)."""
    norm = {SH.ELLIPSOID: SH.SPHERE}
    ta = norm.get(sa.shape_type, sa.shape_type)
    tb = norm.get(sb.shape_type, sb.shape_type)
    if (ta, tb) in _PAIR_TABLE:
        return _PAIR_TABLE[(ta, tb)] + (False,)
    if (tb, ta) in _PAIR_TABLE:
        return _PAIR_TABLE[(tb, ta)] + (True,)
    return None, 0, False


def _sphere_radius(spec: SH.ShapeSpec) -> float:
    if spec.shape_type == SH.ELLIPSOID:
        return float(np.mean(np.asarray(spec.size)) / 2.0)
    return float(np.asarray(spec.size).reshape(-1)[0])


def _members(spec: SH.ShapeSpec) -> List[SH.ShapeSpec]:
    """A sphere set's member spheres as sphere shapes, each centre folded
    into its offset: T_offset @ translation(c)."""
    out = []
    for row in np.asarray(spec.spheres, dtype=np.float64).reshape(-1, 4):
        T = np.eye(4)
        T[:3, 3] = row[:3]
        out.append(SH.ShapeSpec(SH.SPHERE, np.array([row[3]]),
                                T_offset=np.asarray(spec.T_offset, np.float64) @ T))
    return out


def _units(slot: _PairSlot) -> List[_PairSlot]:
    """The primitive tests a slot runs, in its contact order: the slot
    itself, or for a sphere-set kind one test per member sphere (per
    member pair for two sets; the JAX package's _dispatch_multisphere).
    A box's test against a member sphere runs sphere_box with the sphere
    as A (flip: its normal is negated, so that it points from the sphere
    set, body B, to the box)."""
    k = slot.kind
    if "multisphere" not in k:
        return [slot]
    ga, gb, sa, sb = slot.body_a, slot.body_b, slot.shape_a, slot.shape_b
    if k == "multisphere_plane":
        return [_PairSlot("sphere_plane", ga, gb, m, sb, 1) for m in _members(sa)]
    if k == "multisphere_heightmap":
        return [_PairSlot("sphere_heightmap", ga, gb, m, sb, 1) for m in _members(sa)]
    if k == "sphere_multisphere":
        return [_PairSlot("sphere_sphere", ga, gb, sa, m, 1) for m in _members(sb)]
    if k == "capsule_multisphere":
        return [_PairSlot("capsule_sphere", ga, gb, sa, m, 1) for m in _members(sb)]
    if k == "box_multisphere":
        return [_PairSlot("sphere_box", gb, ga, m, sa, 1, flip=True) for m in _members(sb)]
    return [_PairSlot("sphere_sphere", ga, gb, ma, mb, 1)
            for ma in _members(sa) for mb in _members(sb)]


class Collider:
    """Static collision plan for a World."""

    def __init__(self, world: World):
        self.world = world
        self.slots: List[_PairSlot] = []
        self._build()
        # Every slot's primitive tests in contact order, with its slot's
        # index.
        self.units: List[Tuple[int, _PairSlot]] = [
            (i, u) for i, s in enumerate(self.slots) for u in _units(s)]
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

        hull_cache = {}

        def hull_of(spec):
            if id(spec) not in hull_cache:
                hull_cache[id(spec)] = ConvexHull.build(spec.mesh_vertices)
            return hull_cache[id(spec)]

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
                # Mesh hulls are built here; a mesh without vertices
                # collides with nothing.
                hull_a = hull_b = None
                if sa.shape_type == SH.MESH:
                    if sa.mesh_vertices is None:
                        continue
                    hull_a = hull_of(sa)
                if sb.shape_type == SH.MESH:
                    if sb.mesh_vertices is None:
                        continue
                    hull_b = hull_of(sb)
                if "multisphere" in kind:
                    na = len(sa.spheres) if sa.shape_type == SH.MULTI_SPHERE else 1
                    nb = len(sb.spheres) if sb.shape_type == SH.MULTI_SPHERE else 1
                    if kind == "multisphere_multisphere":
                        n_slots = na * nb
                    elif kind in ("box_multisphere", "capsule_multisphere"):
                        n_slots = nb
                    else:
                        n_slots = max(na, nb)
                if kind == "mesh_plane":
                    n_slots = min(8, len(hull_a.verts))
                elif kind == "box_mesh":
                    n_slots = 4 + min(4, len(hull_b.verts))
                elif kind == "mesh_mesh":
                    n_slots = min(4, len(hull_a.verts)) + min(4, len(hull_b.verts))
                self.slots.append(_PairSlot(kind, ga, gb, sa, sb, n_slots, hull_a, hull_b))

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
        """Each test unit's shape offsets, sizes, hulls and heightmaps, and
        the contacts' static columns, as tensors, built once per dtype and
        device."""
        key = (dtype, torch.device(device))
        if key not in self._tensors:
            def t(x):
                return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                                       device=device)

            units = []
            for _, u in self.units:
                c = dict(T_a=t(u.shape_a.T_offset), T_b=t(u.shape_b.T_offset))
                for side, spec, hull in (("a", u.shape_a, u.hull_a), ("b", u.shape_b, u.hull_b)):
                    size = np.asarray(spec.size, dtype=np.float64).reshape(-1)
                    if spec.shape_type == SH.PLANE:
                        c["n_local"] = t(size[:3] / np.linalg.norm(size[:3]))
                        c["d_local"] = t(size[3] if size.size > 3 else 0.0)
                    elif spec.shape_type == SH.BOX:
                        c[f"half_{side}"] = t(size / 2.0)
                    elif spec.shape_type == SH.CAPSULE:
                        c[f"radius_{side}"], c[f"height_{side}"] = t(size[0]), t(size[1])
                    elif spec.shape_type == SH.MESH:
                        c[f"hull_{side}"] = hull
                    elif spec.shape_type == SH.HEIGHTMAP:
                        c["heights"] = t(spec.heights)
                    else:
                        c[f"radius_{side}"] = t(_sphere_radius(spec))
                units.append(c)
            k = [s.n_slots for s in self.slots]

            def per_contact(vals, kind):
                return torch.as_tensor(np.repeat(np.asarray(vals, dtype=kind), k),
                                       device=device)

            self._tensors[key] = dict(
                units=units,
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
        for (_, unit), uc in zip(self.units, c["units"]):
            Ta = T_wb[unit.body_a] @ uc["T_a"]
            Tb = T_wb[unit.body_b] @ uc["T_b"]
            p, n, d = self._dispatch(unit, Ta, Tb, uc)
            pts.append(p)
            nrm.append(-n if unit.flip else n)
            dep.append(d)
        return Contacts(torch.cat(pts), torch.cat(nrm), torch.cat(dep), c["body_a"],
                        c["body_b"], c["friction"], c["restitution"])

    @staticmethod
    def _dispatch(slot: _PairSlot, Ta, Tb, c):
        """One test unit's narrowphase; c: its constants (_consts)."""
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
        if k == "sphere_mesh":
            return nphase.sphere_mesh(Ta[:3, 3], c["radius_a"], Tb, c["hull_b"])
        if k == "capsule_mesh":
            return nphase.capsule_mesh(Ta, c["radius_a"], c["height_a"], Tb, c["hull_b"])
        if k == "box_mesh":
            return nphase.box_mesh(Ta, c["half_a"], Tb, c["hull_b"])
        if k == "mesh_mesh":
            return nphase.mesh_mesh(Ta, c["hull_a"], Tb, c["hull_b"])
        if k.endswith("_heightmap"):
            scale = tuple(slot.shape_b.size)
            if k == "sphere_heightmap":
                return nphase.sphere_heightmap(Ta[:3, 3], c["radius_a"], Tb, c["heights"], scale)
            if k == "capsule_heightmap":
                return nphase.capsule_heightmap(Ta, c["radius_a"], c["height_a"], Tb,
                                                c["heights"], scale)
            return nphase.box_heightmap(Ta, c["half_a"], Tb, c["heights"], scale)
        # The plane kinds: the plane in world coordinates.
        n_w = Tb[:3, :3] @ c["n_local"]
        d_w = c["d_local"] + torch.dot(n_w, Tb[:3, 3])
        if k == "sphere_plane":
            return nphase.sphere_plane(Ta[:3, 3], c["radius_a"], n_w, d_w)
        if k == "box_plane":
            return nphase.box_plane(Ta, c["half_a"], n_w, d_w)
        if k == "capsule_plane":
            return nphase.capsule_plane(Ta, c["radius_a"], c["height_a"], n_w, d_w)
        if k == "mesh_plane":
            return nphase.mesh_plane(Ta, c["hull_a"], n_w, d_w)
        raise NotImplementedError(k)

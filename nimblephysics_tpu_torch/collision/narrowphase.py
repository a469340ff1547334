"""Analytic narrowphase of one world: every primitive shape pair, each
with a fixed number of contact slots.

Counterpart of nimblephysics_tpu/collision/narrowphase.py (sphere_plane
through box_box_sat, the heightmap pairs and ellipsoid_as_sphere) and of
the pair functions of nimblephysics_tpu/collision/convex.py (a hull is a
convex.ConvexHull). Each pair runs the batched
formula of batched/collision.py on a batch of one, so the single world and
the batched engine share one arithmetic. Conventions are the JAX
package's: the normal points from body B (second) to body A (first),
depth > 0 is penetration, a slot with depth <= 0 is empty, the point is
the middle of the penetration. Poses are 4x4 transforms; every function
returns (points (k, 3), normals (k, 3), depths (k,)) and is
differentiable in its geometric inputs.
"""

from __future__ import annotations

import torch

from nimblephysics_tpu_torch.batched import collision as bc
from nimblephysics_tpu_torch.collision import convex


def _s(x, ref):
    """A radius, height or offset as a tensor of ref's dtype and device."""
    if torch.is_tensor(x):
        return x.to(ref.dtype)
    return torch.tensor(float(x), dtype=ref.dtype, device=ref.device)


def _col(x):
    """(3,) -> (3, 1): a batch of one in batched/collision's layout."""
    return x[:, None]


def _out(points, normals, depths):
    """(k, 3, 1), (k, 3, 1), (k, 1) -> (k, 3), (k, 3), (k,)."""
    return points[..., 0], normals[..., 0], depths[..., 0]


def sphere_plane(center, radius, plane_normal, plane_offset):
    """Sphere (A) against a plane {x : n . x = offset} (B): 1 slot."""
    r = _s(radius, center).reshape(1, 1, 1)
    d = _s(plane_offset, center).reshape(1, 1)
    p, n, dep = bc.sphere_plane_b(center[None, :, None], r, plane_normal[None, :, None], d)
    return _out(p, n, dep)


def sphere_sphere(c_a, r_a, c_b, r_b):
    """Two spheres: 1 slot."""
    return _out(*bc._sphere_sphere_flat(_col(c_a), _s(r_a, c_a).reshape(1), _col(c_b),
                                        _s(r_b, c_a).reshape(1)))


def sphere_box(center, radius, T_box, half_extents):
    """Sphere (A) against a box (B): 1 slot, the closest point or, with
    the center inside, out through the nearest face."""
    return _out(*bc._sphere_box_flat(_col(center), _s(radius, center).reshape(1),
                                     T_box[:3, :3, None], _col(T_box[:3, 3]),
                                     _col(half_extents)))


def box_plane(T_box, half_extents, plane_normal, plane_offset):
    """Box (A) against a plane (B): 8 slots, one per corner."""
    d = _s(plane_offset, T_box).reshape(1, 1)
    p, n, dep = bc.box_plane_b(T_box[None, :3, :3, None], T_box[None, :3, 3, None],
                               half_extents[None, :, None], plane_normal[None, :, None], d)
    return _out(p, n, dep)


def capsule_plane(T_cap, radius, height, plane_normal, plane_offset):
    """Capsule (A, axis local z) against a plane (B): 2 slots, the end
    spheres at +h/2 and -h/2."""
    d = _s(plane_offset, T_cap).reshape(1, 1)
    p, n, dep = bc.capsule_plane_b(
        T_cap[None, :3, :3, None], T_cap[None, :3, 3, None],
        _s(radius, T_cap).reshape(1, 1, 1), _s(height, T_cap).reshape(1, 1, 1),
        plane_normal[None, :, None], d)
    return _out(p, n, dep)


def capsule_sphere(T_cap, radius_c, height, c_sphere, r_sphere):
    """Capsule (A) against a sphere (B): 1 slot."""
    return _out(*bc._capsule_sphere_flat(
        T_cap[:3, :3, None], _col(T_cap[:3, 3]), _s(radius_c, T_cap).reshape(1),
        _s(height, T_cap).reshape(1), _col(c_sphere), _s(r_sphere, T_cap).reshape(1)))


def capsule_capsule(T_a, r_a, h_a, T_b, r_b, h_b):
    """Two capsules: 1 slot, the closest points of their axis segments."""
    return _out(*bc._capsule_capsule_flat(
        T_a[:3, :3, None], _col(T_a[:3, 3]), _s(r_a, T_a).reshape(1), _s(h_a, T_a).reshape(1),
        T_b[:3, :3, None], _col(T_b[:3, 3]), _s(r_b, T_a).reshape(1), _s(h_b, T_a).reshape(1)))


def capsule_box(T_cap, radius, height, T_box, half_extents):
    """Capsule (A) against a box (B): 3 slots, the end spheres at -h/2 and
    +h/2 and a flank point found by alternating projection."""
    return _out(*bc._capsule_box_flat(
        T_cap[:3, :3, None], _col(T_cap[:3, 3]), _s(radius, T_cap).reshape(1),
        _s(height, T_cap).reshape(1), T_box[:3, :3, None], _col(T_box[:3, 3]),
        _col(half_extents)))


def box_box_sat(T_a, half_a, T_b, half_b):
    """Box-box separating-axis test with the clipped 8-slot manifold (the
    best face of either box clipped against the other's incident face, or
    one edge-edge contact); unused slots have depth -1."""
    return _out(*bc._box_box_flat(T_a[:3, :3, None], _col(T_a[:3, 3]), _col(half_a),
                                  T_b[:3, :3, None], _col(T_b[:3, 3]), _col(half_b)))


def _hull(hull: convex.ConvexHull, ref):
    """A hull's tensors in ref's dtype and on its device."""
    return hull.tensors(ref.dtype, ref.device)


def _pose(T):
    """A 4x4 pose as a batch of one: (3, 3, 1), (3, 1)."""
    return T[:3, :3, None], _col(T[:3, 3])


def mesh_plane(T_mesh, hull, plane_normal, plane_offset):
    """Mesh (A) against a plane (B): min(8, V) slots, the deepest hull
    vertices."""
    h = _hull(hull, T_mesh)
    return _out(*convex.mesh_plane_flat(h, min(8, h[0].shape[0]), *_pose(T_mesh),
                                        _col(plane_normal), _s(plane_offset, T_mesh).reshape(1)))


def sphere_mesh(center, radius, T_mesh, hull):
    """Sphere (A) against a mesh (B): 1 slot."""
    return _out(*convex.sphere_mesh_flat(_hull(hull, center), _col(center),
                                         _s(radius, center).reshape(1), *_pose(T_mesh)))


def capsule_mesh(T_cap, radius, height, T_mesh, hull):
    """Capsule (A) against a mesh (B): 3 slots of 5 samples along the
    axis."""
    return _out(*convex.capsule_mesh_flat(_hull(hull, T_cap), *_pose(T_cap),
                                          _s(radius, T_cap).reshape(1),
                                          _s(height, T_cap).reshape(1), *_pose(T_mesh)))


def box_mesh(T_box, half_extents, T_mesh, hull):
    """Box (A) against a mesh (B): 4 corner slots, then min(4, V) hull
    vertex slots."""
    h = _hull(hull, T_box)
    return _out(*convex.box_mesh_flat(h, min(4, h[0].shape[0]), *_pose(T_box),
                                      _col(half_extents), *_pose(T_mesh)))


def mesh_mesh(T_a, hull_a, T_b, hull_b):
    """Mesh (A) against mesh (B): A's vertices in B, then B's in A, at most
    4 slots each."""
    ha, hb = _hull(hull_a, T_a), _hull(hull_b, T_a)
    return _out(*convex.mesh_mesh_flat(ha, hb, min(4, ha[0].shape[0]), min(4, hb[0].shape[0]),
                                       *_pose(T_a), *_pose(T_b)))


def sphere_heightmap(center, radius, T_hm, heights, scale):
    """Sphere (A) against a heightmap (B, heights (H, W), scale (sx, sy,
    sz)): 1 slot; depth -1 off the grid."""
    return _out(*bc._sphere_heightmap_flat(bc.Heightmap.of(heights.to(center.dtype), scale),
                                           _col(center), _s(radius, center).reshape(1),
                                           *_pose(T_hm)))


def capsule_heightmap(T_cap, radius, height, T_hm, heights, scale):
    """Capsule (A) against a heightmap (B): 3 slots, spheres at -h/2, 0,
    +h/2."""
    return _out(*bc._capsule_heightmap_flat(
        bc.Heightmap.of(heights.to(T_cap.dtype), scale), *_pose(T_cap),
        _s(radius, T_cap).reshape(1), _s(height, T_cap).reshape(1), *_pose(T_hm)))


def box_heightmap(T_box, half_extents, T_hm, heights, scale):
    """Box (A) against a heightmap (B): 8 corner slots."""
    return _out(*bc._box_heightmap_flat(bc.Heightmap.of(heights.to(T_box.dtype), scale),
                                        *_pose(T_box), _col(half_extents), *_pose(T_hm)))


def ellipsoid_as_sphere(size):
    """The radius an ellipsoid collides with: its mean semi-axis."""
    return torch.mean(torch.as_tensor(size, dtype=torch.float64)) / 2.0

"""Batched narrowphase: the collider's static slot plan evaluated with the
world batch in the trailing axis.

Counterpart of nimblephysics_tpu/batched/collision.py for every pair kind
of the slot plan (formula parity with its sphere_plane_b, sphere_sphere_b,
sphere_box_b, capsule_plane_b, capsule_sphere_b, capsule_capsule_b,
box_plane_b and box_box_b). capsule_box follows the single-world
narrowphase.capsule_box of the JAX package: the plan gives the pair 3
slots (the two end spheres and a flank point), where that package's
batched capsule_box_b returns only the 2 end spheres. All slots of one
kind are evaluated together as one batched op. Per-contact outputs:
point (C, 3, B), normal (C, 3, B), depth (C, B), in slot order. Every
constant a kind reads is built with the plan (BatchedCollider._consts),
so a call copies nothing from the host.

box_box_b is the clipped separating-axis manifold (DARTCollide.cpp:1452
dBoxBox re-designed): 15 axes scored, the best face of either box clipped
against the other's incident face, or one edge-edge contact, in 8 slots
whose unused entries have depth -1. Inside, a kind's slots are flattened
into the batch axis, (3, S B), so that every formula reads as the JAX
package's.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.batched import linalg as bl
from nimblephysics_tpu_torch.collision import convex
from nimblephysics_tpu_torch.collision.collider import Collider, _sphere_radius

_EPS = 1e-12
_BOX_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
)
_RECT_SIGNS = [(1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0)]
# box_box's axis preference: the 9 edge-cross axes pay 1e-4 against the
# 6 face axes.
_AXIS_PENALTY = [0.0] * 6 + [1e-4] * 9


@functools.lru_cache(maxsize=16)
def _statics(dtype, device) -> SimpleNamespace:
    """The constant tensors of the pair kinds, built once per dtype and
    device: the 8 corner signs of a box (8, 3), the 4 rectangle corner
    signs of the face manifold (4, 2, 1), box_box's axis penalties
    (15, 1) and the unit z fallback normal (3, 1)."""
    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=device)

    return SimpleNamespace(box_signs=t(_BOX_SIGNS), rect_signs=t(_RECT_SIGNS)[:, :, None],
                           axis_penalty=t(_AXIS_PENALTY)[:, None],
                           ez=t([0.0, 0.0, 1.0])[:, None])


def sphere_plane_b(center, radius, n_w, d_w):
    """center (S, 3, B), radius (S, 1, 1), plane normal (S, 3, B), offset
    (S, B) -> point (S, 3, B), normal (S, 3, B), depth (S, B)."""
    dist = torch.sum(center * n_w, dim=1) - d_w
    depth = radius[:, 0, :] - dist
    point = center - n_w * (radius - 0.5 * depth[:, None, :])
    return point, n_w, depth


def capsule_plane_b(R_cap, p_cap, radius, height, n_w, d_w):
    """Both end spheres of capsules against planes.

    R_cap (S, 3, 3, B), p_cap (S, 3, B), radius/height (S, 1, 1) ->
    contacts ordered [+h/2 end, -h/2 end] per slot: (2S, 3, B), (2S, B).
    """
    axis = R_cap[:, :, 2]  # local z in world, (S, 3, B)
    outs = [
        sphere_plane_b(p_cap + axis * (sgn * height / 2.0), radius, n_w, d_w)
        for sgn in (1.0, -1.0)
    ]
    S, B = p_cap.shape[0], p_cap.shape[-1]
    return (
        torch.stack([outs[0][0], outs[1][0]], dim=1).reshape(2 * S, 3, B),
        torch.stack([outs[0][1], outs[1][1]], dim=1).reshape(2 * S, 3, B),
        torch.stack([outs[0][2], outs[1][2]], dim=1).reshape(2 * S, B),
    )


def box_plane_b(R_box, p_box, half, n_w, d_w):
    """The 8 corners of boxes against planes: R_box (S, 3, 3, B), p_box
    (S, 3, B), half sizes (S, 3, 1), plane normal (S, 3, B) and offset
    (S, B) -> contacts ordered by corner per slot: (8S, 3, B), (8S, B)."""
    S, B = p_box.shape[0], p_box.shape[-1]
    signs = _statics(p_box.dtype, p_box.device).box_signs
    local = signs[None, :, :, None] * half[:, None]  # (S, 8, 3, 1)
    corner = torch.einsum("sijb,skjb->skib", R_box, local) + p_box[:, None]
    depth = -(torch.sum(corner * n_w[:, None], dim=2) - d_w[:, None])  # (S, 8, B)
    point = corner + 0.5 * depth[:, :, None] * n_w[:, None]
    normal = n_w[:, None].expand(S, 8, 3, B)
    return point.reshape(8 * S, 3, B), normal.reshape(8 * S, 3, B), depth.reshape(8 * S, B)


def _to_flat(x):
    """A kind's per-slot input, (S, ..., B or 1), -> (..., S B): the slots
    flattened into the batch axis."""
    S = x.shape[0]
    return x.movedim(0, -2).reshape(*x.shape[1:-1], S * x.shape[-1])


def _per_slot(flat_fn, B, *args):
    """Run flat_fn on the slots flattened into the batch axis: args (S,
    ..., B or 1), broadcast to B, -> its (m, 3, S B), (m, 3, S B), (m, S B)
    outputs as (m S, 3, B), (m S, 3, B), (m S, B), in slot order."""
    S = args[0].shape[0]
    flat = [_to_flat(x.expand(*x.shape[:-1], B)) for x in args]
    out = flat_fn(*flat)
    return tuple(
        x.reshape(*x.shape[:-1], S, B).movedim(-2, 0).reshape(S * x.shape[0], *x.shape[1:-1], B)
        for x in out
    )


def _safe_normalize_b(v, fallback):
    """(3, N) normalized, with fallback (3, 1) where |v|^2 < 1e-12 (no
    division by zero in either the value or its gradient)."""
    n2 = torch.sum(v * v, dim=0, keepdim=True)
    small = n2 < _EPS
    unit = v / torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    return torch.where(small, fallback, unit)


def _sphere_sphere_flat(c_a, r_a, c_b, r_b):
    """Spheres (centers (3, N), radii (N,)): 1 contact, normal from B to A."""
    d = c_a - c_b
    d2 = torch.sum(d * d, dim=0)
    small = d2 < _EPS
    dist = torch.where(small, torch.zeros_like(d2),
                       torch.sqrt(torch.where(small, torch.ones_like(d2), d2)))
    n = _safe_normalize_b(d, _statics(d.dtype, d.device).ez)
    depth = (r_a + r_b) - dist
    point = c_b + n * (r_b - 0.5 * depth)
    return point[None], n[None], depth[None]


def _sphere_box_flat(center, radius, R_box, p_box, half):
    """Sphere (A) against box (B, half sizes (3, N)): the closest point
    in the box frame, or, with the center inside, out through the nearest
    face. 1 contact."""
    ez = _statics(center.dtype, center.device).ez
    c_local = bl.mtv(R_box, center - p_box)
    clamped = torch.minimum(torch.maximum(c_local, -half), half)
    delta = c_local - clamped
    d2 = torch.sum(delta * delta, dim=0)
    outside = d2 > _EPS
    n_out = _safe_normalize_b(delta, ez)
    dist_out = torch.where(outside, torch.sqrt(torch.where(outside, d2, torch.ones_like(d2))),
                           torch.zeros_like(d2))
    face_dist = half - torch.abs(c_local)
    onehot = _one_hot_b(torch.argmin(face_dist, dim=0), 3, center.dtype)
    n_in = onehot * torch.sign(torch.sum(c_local * onehot, dim=0) + _EPS)
    dist_in = -torch.amin(face_dist, dim=0)
    n_local = torch.where(outside, n_out, n_in)
    depth = radius - torch.where(outside, dist_out, dist_in)
    n_world = bl.mv(R_box, n_local)
    surf_local = torch.where(outside, clamped, c_local - n_local * dist_in)
    point = 0.5 * (bl.mv(R_box, surf_local) + p_box + (center - n_world * radius))
    return point[None], n_world[None], depth[None]


def _segment_closest_b(p, a, b):
    ab = b - a
    denom = torch.clamp(torch.sum(ab * ab, dim=0), min=_EPS)
    t = torch.clamp(bl.dot(p - a, ab) / denom, 0.0, 1.0)
    return a + t * ab


def _segment_ends(R, p, height):
    """A capsule's axis segment (local z): its -h/2 and +h/2 ends."""
    half = R[:, 2] * (height / 2.0)
    return p - half, p + half


def _capsule_sphere_flat(R_cap, p_cap, r_c, h, c_sphere, r_s):
    a, b = _segment_ends(R_cap, p_cap, h)
    return _sphere_sphere_flat(_segment_closest_b(c_sphere, a, b), r_c, c_sphere, r_s)


def _capsule_capsule_flat(R_a, p_a, r_a, h_a, R_b, p_b, r_b, h_b):
    """The closest points of the two axis segments as spheres: 1 contact."""
    a0, a1 = _segment_ends(R_a, p_a, h_a)
    b0, b1 = _segment_ends(R_b, p_b, h_b)
    d1, d2, r = a1 - a0, b1 - b0, a0 - b0
    a = torch.sum(d1 * d1, dim=0)
    e = torch.sum(d2 * d2, dim=0)
    f = torch.sum(d2 * r, dim=0)
    c = torch.sum(d1 * r, dim=0)
    b = torch.sum(d1 * d2, dim=0)
    denom = torch.clamp(a * e - b * b, min=_EPS)
    s = torch.clamp((b * f - c * e) / denom, 0.0, 1.0)
    t = torch.clamp((b * s + f) / torch.clamp(e, min=_EPS), 0.0, 1.0)
    s = torch.clamp((b * t - c) / torch.clamp(a, min=_EPS), 0.0, 1.0)
    return _sphere_sphere_flat(a0 + s * d1, r_a, b0 + t * d2, r_b)


def _capsule_box_flat(R_cap, p_cap, radius, height, R_box, p_box, half):
    """Capsule (A) against box (B): 3 contacts, the end spheres at -h/2
    and +h/2 and a flank point, the segment point closest to the box after
    8 rounds of alternating projection (segment -> box -> segment),
    dropped (depth -1) within 5% of the half height of an end
    (narrowphase.capsule_box of the JAX package)."""
    a, b = _segment_ends(R_cap, p_cap, height)
    outs = [_sphere_box_flat(end, radius, R_box, p_box, half) for end in (a, b)]
    p_seg = p_cap
    for _ in range(8):
        local = bl.mtv(R_box, p_seg - p_box)
        on_box = bl.mv(R_box, torch.minimum(torch.maximum(local, -half), half)) + p_box
        p_seg = _segment_closest_b(on_box, a, b)
    pt, nrm, dep = _sphere_box_flat(p_seg, radius, R_box, p_box, half)
    t_end = torch.minimum(torch.sqrt(torch.sum((p_seg - a) ** 2, dim=0)),
                          torch.sqrt(torch.sum((p_seg - b) ** 2, dim=0)))
    dup = t_end < 0.05 * (height / 2.0) + 1e-9
    outs.append((pt, nrm, torch.where(dup, -torch.ones_like(dep), dep)))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def sphere_sphere_b(c_a, r_a, c_b, r_b):
    """Sphere pairs: centers (S, 3, B), radii (S, 1, 1) -> (S, 3, B),
    (S, 3, B), (S, B)."""
    return _per_slot(_sphere_sphere_flat, c_a.shape[-1], c_a, r_a[:, 0], c_b, r_b[:, 0])


def sphere_box_b(center, radius, R_box, p_box, half):
    """Sphere-box pairs: centers (S, 3, B), radii (S, 1, 1), box rotations
    (S, 3, 3, B), positions (S, 3, B), half sizes (S, 3, 1) -> 1 contact
    a pair."""
    return _per_slot(_sphere_box_flat, center.shape[-1], center, radius[:, 0],
                     R_box, p_box, half)


def capsule_sphere_b(R_cap, p_cap, r_c, h, c_sphere, r_s):
    """Capsule-sphere pairs (capsule radius and height (S, 1, 1)): 1 contact
    a pair."""
    return _per_slot(_capsule_sphere_flat, p_cap.shape[-1], R_cap, p_cap, r_c[:, 0],
                     h[:, 0], c_sphere, r_s[:, 0])


def capsule_capsule_b(R_a, p_a, r_a, h_a, R_b, p_b, r_b, h_b):
    """Capsule pairs: 1 contact a pair."""
    return _per_slot(_capsule_capsule_flat, p_a.shape[-1], R_a, p_a, r_a[:, 0],
                     h_a[:, 0], R_b, p_b, r_b[:, 0], h_b[:, 0])


def capsule_box_b(R_cap, p_cap, radius, height, R_box, p_box, half):
    """Capsule-box pairs: 3 contacts a pair, ordered [-h/2 end, +h/2 end,
    flank]."""
    return _per_slot(_capsule_box_flat, p_cap.shape[-1], R_cap, p_cap, radius[:, 0],
                     height[:, 0], R_box, p_box, half)


def _one_hot_b(idx, n, dtype):
    """(N,) int -> (n, N) one-hot."""
    return (idx[None, :] == torch.arange(n, device=idx.device)[:, None]).to(dtype)


def _sign(x):
    """sign(x + 1e-30): +1 at zero, as the JAX package breaks the tie."""
    return torch.sign(x + 1e-30)


def _box_face_manifold_b(R_r, p_r, h_r, R_i, p_i, h_i, face_idx, flip_normal):
    """Reference box r's face face_idx (N,) clipped against box i's most
    anti-parallel face: (points (8, 3, N), normals (8, 3, N), depths
    (8, N)). Rotations (3, 3, N), positions and half sizes (3, N)."""
    dtype = R_r.dtype
    N = p_r.shape[-1]
    e = _one_hot_b(face_idx, 3, dtype)  # (3, N)
    e_u = _one_hot_b((face_idx + 1) % 3, 3, dtype)
    e_v = _one_hot_b((face_idx + 2) % 3, 3, dtype)
    a_r = bl.mv(R_r, e)
    n_ref = a_r * _sign(bl.dot(a_r, p_i - p_r))
    u = bl.mv(R_r, e_u)
    v = bl.mv(R_r, e_v)
    h_face = torch.sum(h_r * e, dim=0)
    h_u = torch.sum(h_r * e_u, dim=0)
    h_v = torch.sum(h_r * e_v, dim=0)
    face_origin = p_r + n_ref * h_face

    dots = bl.mtv(R_i, n_ref)  # (3, N)
    inc_idx = torch.argmax(torch.abs(dots), dim=0)
    ei = _one_hot_b(inc_idx, 3, dtype)
    ei_u = _one_hot_b((inc_idx + 1) % 3, 3, dtype)
    ei_v = _one_hot_b((inc_idx + 2) % 3, 3, dtype)
    s_i = -_sign(torch.sum(dots * ei, dim=0))
    n_inc = bl.mv(R_i, ei) * s_i
    inc_center = p_i + n_inc * torch.sum(h_i * ei, dim=0)
    iu = bl.mv(R_i, ei_u)
    iv = bl.mv(R_i, ei_v)
    hi_u = torch.sum(h_i * ei_u, dim=0)
    hi_v = torch.sum(h_i * ei_v, dim=0)

    corners3d = torch.stack(
        [inc_center + su * hi_u * iu + sv * hi_v * iv for su, sv in _RECT_SIGNS]
    )  # (4, 3, N)
    rel = corners3d - face_origin[None]
    quad = torch.stack(
        [torch.sum(rel * u[None], dim=1), torch.sum(rel * v[None], dim=1)], dim=1
    )  # (4, 2, N)
    rect = _statics(dtype, p_r.device).rect_signs * torch.stack([h_u, h_v])[None]  # (4, 2, N)

    # (a) incident corners inside the rect.
    in_rect = (torch.abs(quad[:, 0]) <= h_u[None] + 1e-9) & (
        torch.abs(quad[:, 1]) <= h_v[None] + 1e-9
    )  # (4, N)
    # (b) rect corners inside the incident quad.
    qa = quad
    qb = torch.roll(quad, -1, dims=0)
    edge = qb - qa
    rel_r = rect[:, None] - qa[None]  # (4 rect, 4 edges, 2, N)
    cross2 = edge[None, :, 0] * rel_r[:, :, 1] - edge[None, :, 1] * rel_r[:, :, 0]
    in_quad = torch.all(cross2 <= 1e-9, dim=1) | torch.all(cross2 >= -1e-9, dim=1)
    # (c) quad-edge x rect-edge intersections.
    ra = rect
    rb = torch.roll(rect, -1, dims=0)
    d1 = qb - qa
    d2 = rb - ra
    denom = d1[:, None, 0] * d2[None, :, 1] - d1[:, None, 1] * d2[None, :, 0]
    degen = torch.abs(denom) < 1e-12
    denom_s = torch.where(degen, torch.ones_like(denom), denom)
    diff = ra[None, :] - qa[:, None]  # (4, 4, 2, N)
    t = (diff[:, :, 0] * d2[None, :, 1] - diff[:, :, 1] * d2[None, :, 0]) / denom_s
    s = (diff[:, :, 0] * d1[:, None, 1] - diff[:, :, 1] * d1[:, None, 0]) / denom_s
    inter_ok = (~degen) & (t >= -1e-9) & (t <= 1.0 + 1e-9) & (s >= -1e-9) & (s <= 1.0 + 1e-9)
    inter_pts = qa[:, None] + t[:, :, None] * d1[:, None]  # (4, 4, 2, N)

    cand = torch.cat([quad, rect, inter_pts.reshape(16, 2, N)])  # (24, 2, N)
    cand_ok = torch.cat([in_rect, in_quad, inter_ok.reshape(16, N)])  # (24, N)

    denom_p = bl.dot(n_inc, n_ref)
    denom_p = torch.where(torch.abs(denom_p) < 1e-6, torch.full_like(denom_p, -1e-6), denom_p)
    c0 = bl.dot(n_inc, face_origin - inc_center) / denom_p
    c1 = bl.dot(n_inc, u) / denom_p
    c2 = bl.dot(n_inc, v) / denom_p
    depth_cand = c0 + c1 * cand[:, 0] + c2 * cand[:, 1]
    depth_cand = torch.where(cand_ok, depth_cand, -torch.ones_like(depth_cand))

    # The 8 deepest by repeated masked max: taken candidates drop to -2,
    # invalid ones read -1.
    sel_list, dep_list = [], []
    dc = depth_cand
    for _ in range(8):
        oh = _one_hot_b(torch.argmax(dc, dim=0), 24, dtype)  # (24, N)
        dep_list.append(torch.sum(dc * oh, dim=0))
        sel_list.append(torch.sum(cand * oh[:, None], dim=0))  # (2, N)
        dc = torch.where(oh > 0, torch.full_like(dc, -2.0), dc)
    depths = torch.stack(dep_list)  # (8, N)
    sel = torch.stack(sel_list)  # (8, 2, N)

    n_contact = -n_ref if flip_normal else n_ref
    surf = (face_origin[None] + sel[:, 0][:, None] * u[None]
            + sel[:, 1][:, None] * v[None] - depths[:, None] * n_ref[None])
    points = surf + 0.5 * depths[:, None] * n_ref[None]
    return points, n_contact[None].expand(8, 3, N), depths


def _box_edge_contact_b(R_a, p_a, h_a, R_b, p_b, h_b, edge_idx, axis_w, sep):
    """One edge-edge contact for edge pair edge_idx = 3 i + j (N,) along
    axis_w (3, N) at separation sep (N,), in slot 0 of 8 (depth -1 in the
    rest)."""
    N = p_a.shape[-1]
    ei = _one_hot_b(torch.div(edge_idx, 3, rounding_mode="floor"), 3, R_a.dtype)
    ej = _one_hot_b(edge_idx % 3, 3, R_a.dtype)
    u = axis_w
    sa = _sign(bl.mtv(R_a, u)) * (1.0 - ei)
    ca = p_a + bl.mv(R_a, sa * h_a)
    da = bl.mv(R_a, ei)
    sb = _sign(bl.mtv(R_b, -u)) * (1.0 - ej)
    cb = p_b + bl.mv(R_b, sb * h_b)
    db = bl.mv(R_b, ej)
    r = cb - ca
    a_ = bl.dot(da, da)
    b_ = bl.dot(da, db)
    e_ = bl.dot(db, db)
    c_ = bl.dot(da, r)
    f_ = bl.dot(db, r)
    den = torch.clamp(a_ * e_ - b_ * b_, min=1e-12)
    t = (c_ * e_ - b_ * f_) / den
    s = (b_ * c_ - a_ * f_) / den
    la = torch.sum(h_a * ei, dim=0)
    lb = torch.sum(h_b * ej, dim=0)
    t = torch.minimum(torch.maximum(t, -la), la)
    s = torch.minimum(torch.maximum(s, -lb), lb)
    point = 0.5 * ((ca + t * da) + (cb + s * db))
    depths = torch.cat([(-sep)[None], torch.full((7, N), -1.0, dtype=sep.dtype,
                                                 device=sep.device)])
    return point[None].expand(8, 3, N), (-u)[None].expand(8, 3, N), depths


def _box_box_flat(R_a, p_a, h_a, R_b, p_b, h_b):
    """box_box_b with the pairs in the batch axis: rotations (3, 3, N),
    positions and half sizes (3, N) -> (8, 3, N), (8, 3, N), (8, N)."""
    dtype = R_a.dtype
    C = bl.mtm(R_a, R_b)  # R_a^T R_b
    absC = torch.abs(C) + 1e-9
    t = bl.mtv(R_a, p_b - p_a)

    seps, world_axes = [], []
    for i in range(3):  # face axes of A
        seps.append(torch.abs(t[i]) - (h_a[i] + torch.sum(absC[i] * h_b, dim=0)))
        world_axes.append(R_a[:, i] * _sign(t[i]))
    tb = bl.mtv(C, t)  # the centre offset in B's frame
    for j in range(3):  # face axes of B
        seps.append(torch.abs(tb[j]) - (h_b[j] + torch.sum(absC[:, j] * h_a, dim=0)))
        world_axes.append(R_b[:, j] * _sign(tb[j]))
    for i in range(3):  # edge-cross axes a_i x b_j, double-where at parallel edges
        for j in range(3):
            axis = bl.cross(R_a[:, i], R_b[:, j])
            n2 = torch.sum(axis * axis, dim=0)
            degen = n2 < 1e-12
            norm = torch.sqrt(torch.where(degen, torch.ones_like(n2), n2))
            norm = torch.where(degen, torch.zeros_like(norm), norm)
            u = torch.where(degen, torch.zeros_like(axis), axis) / torch.where(
                degen, torch.ones_like(norm), norm)
            ra = torch.sum(h_a * torch.abs(bl.mtv(R_a, u)), dim=0)
            rb = torch.sum(h_b * torch.abs(bl.mtv(R_b, u)), dim=0)
            dist = bl.dot(u, p_b - p_a)
            sep = torch.abs(dist) - (ra + rb)
            sep = torch.where(norm < 1e-6, torch.full_like(sep, float("-inf")), sep)
            world_axes.append(u * _sign(dist))
            seps.append(sep)

    seps_arr = torch.stack(seps)  # (15, N)
    axes_arr = torch.stack(world_axes)  # (15, 3, N)
    score = seps_arr - _statics(dtype, p_a.device).axis_penalty
    best = torch.argmax(score, dim=0)
    separated = torch.amax(seps_arr, dim=0) >= 0.0

    ptsA, nrmA, depA = _box_face_manifold_b(
        R_a, p_a, h_a, R_b, p_b, h_b, torch.argmax(score[0:3], dim=0), flip_normal=True)
    ptsB, nrmB, depB = _box_face_manifold_b(
        R_b, p_b, h_b, R_a, p_a, h_a, torch.argmax(score[3:6], dim=0), flip_normal=False)
    bestE = torch.argmax(score[6:15], dim=0)
    ohE = _one_hot_b(bestE, 9, dtype)
    axisE = torch.sum(axes_arr[6:15] * ohE[:, None], dim=0)
    # A where-gather, not a product: degenerate axes hold -inf.
    sepE = torch.sum(torch.where(ohE > 0, seps_arr[6:15], torch.zeros_like(seps_arr[6:15])), dim=0)
    ptsE, nrmE, depE = _box_edge_contact_b(R_a, p_a, h_a, R_b, p_b, h_b, bestE, axisE, sepE)

    is_face_a = best < 3
    is_face_b = (best >= 3) & (best < 6)
    pts = torch.where(is_face_a, ptsA, torch.where(is_face_b, ptsB, ptsE))
    nrm = torch.where(is_face_a, nrmA, torch.where(is_face_b, nrmB, nrmE))
    dep = torch.where(is_face_a, depA, torch.where(is_face_b, depB, depE))
    dep = torch.where(separated, -torch.ones_like(dep), dep)
    return pts, nrm, dep


def box_box_b(R_a, p_a, half_a, R_b, p_b, half_b):
    """Box-box SAT with the clipped 8-slot manifold for S pairs: rotations
    (S, 3, 3, B), positions (S, 3, B), half sizes (S, 3, 1) -> contacts
    ordered by slot, 8 per pair: (8S, 3, B), (8S, 3, B), (8S, B)."""
    S, B = p_a.shape[0], p_a.shape[-1]

    def rot(R):
        return R.permute(1, 2, 0, 3).reshape(3, 3, S * B)

    def vec(x):
        return x.expand(S, 3, B).permute(1, 0, 2).reshape(3, S * B)

    pts, nrm, dep = _box_box_flat(rot(R_a), vec(p_a), vec(half_a),
                                  rot(R_b), vec(p_b), vec(half_b))

    def back(x):  # (8, ..., S B) -> (8 S, ..., B)
        return x.reshape(*x.shape[:-1], S, B).movedim(-2, 0).reshape(8 * S, *x.shape[1:-1], B)

    return back(pts), back(nrm), back(dep)


class Heightmap(NamedTuple):
    """A heightmap's constants: heights (H, W) as a tensor, its size H, W
    and its grid spacing and height scale sx, sy, sz (with their
    reciprocals, so that the card and the CPU round alike: torch divides
    by a Python number on the card as a product with its reciprocal)."""

    heights: torch.Tensor
    H: int
    W: int
    inv_sx: float
    inv_sy: float
    sz: float
    sz_sx: float
    sz_sy: float

    @staticmethod
    def of(heights: torch.Tensor, scale) -> "Heightmap":
        sx, sy, sz = (float(x) for x in scale)
        H, W = heights.shape
        return Heightmap(heights, H, W, 1.0 / sx, 1.0 / sy, sz, sz / sx, sz / sy)


def _heightmap_sample(hm: Heightmap, x, y):
    """Bilinear height, the bilinear patch's up normal (3, N) and whether
    (x, y) (N,) lies over the grid, in the heightmap's frame
    (collision/narrowphase._heightmap_sample of the JAX package). The
    clip to W - 1 - 1e-9 rounds to W - 1 in float32, as it does there,
    and the last cell then takes fx = 1."""
    W, H = hm.W, hm.H
    gx = x * hm.inv_sx + (W - 1) / 2.0
    gy = y * hm.inv_sy + (H - 1) / 2.0
    inside = (gx >= 0.0) & (gx <= W - 1) & (gy >= 0.0) & (gy <= H - 1)
    gx = torch.clamp(gx, 0.0, W - 1 - 1e-9)
    gy = torch.clamp(gy, 0.0, H - 1 - 1e-9)
    i0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, W - 2)
    j0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, H - 2)
    fx = gx - i0.to(gx.dtype)
    fy = gy - j0.to(gy.dtype)
    h00 = hm.heights[j0, i0]
    h10 = hm.heights[j0, i0 + 1]
    h01 = hm.heights[j0 + 1, i0]
    h11 = hm.heights[j0 + 1, i0 + 1]
    h = ((1 - fx) * (1 - fy) * h00 + fx * (1 - fy) * h10
         + (1 - fx) * fy * h01 + fx * fy * h11) * hm.sz
    dh_dx = ((1 - fy) * (h10 - h00) + fy * (h11 - h01)) * hm.sz_sx
    dh_dy = ((1 - fx) * (h01 - h00) + fx * (h11 - h10)) * hm.sz_sy
    n = torch.stack([-dh_dx, -dh_dy, torch.ones_like(h)])
    return h, n / torch.sqrt(torch.sum(n * n, dim=0)), inside


def _sphere_heightmap_flat(hm, center, radius, R_hm, p_hm):
    """Sphere (A) against a heightmap (B): 1 contact, the gap along the
    vertical projected on the patch normal (exact on flat cells); depth
    -1 off the grid."""
    c_local = bl.mtv(R_hm, center - p_hm)
    h, n_local, inside = _heightmap_sample(hm, c_local[0], c_local[1])
    gap = (c_local[2] - h) * n_local[2]
    depth = torch.where(inside, radius - gap, -torch.ones_like(gap))
    n_world = bl.mv(R_hm, n_local)
    point = center - n_world * (radius - 0.5 * depth)
    return point[None], n_world[None], depth[None]


def _capsule_heightmap_flat(hm, R_cap, p_cap, radius, height, R_hm, p_hm):
    """Capsule (A) against a heightmap (B): 3 contacts, spheres at -h/2,
    0 and +h/2 along the axis."""
    axis = R_cap[:, 2]
    outs = [_sphere_heightmap_flat(hm, p_cap + axis * (t * height), radius, R_hm, p_hm)
            for t in (-0.5, 0.0, 0.5)]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def _box_heightmap_flat(hm, R_box, p_box, half, R_hm, p_hm):
    """Box (A) against a heightmap (B): the 8 corners as points."""
    signs = _statics(p_box.dtype, p_box.device).box_signs
    zero = torch.zeros_like(p_box[0])
    outs = [_sphere_heightmap_flat(hm, bl.mv(R_box, s[:, None] * half) + p_box, zero, R_hm, p_hm)
            for s in signs]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def _group_key(unit) -> tuple:
    """The batched evaluation group of a test unit: its kind, whether its
    normal is negated, and the hulls or heightmap it reads (a group shares
    them)."""
    hm = id(unit.shape_b) if unit.kind.endswith("_heightmap") else None
    return (unit.kind, unit.flip, id(unit.hull_a) if unit.hull_a is not None else None,
            id(unit.hull_b) if unit.hull_b is not None else None, hm)


class BatchedCollider:
    """Evaluates a Collider's static slot plan on a world batch: its test
    units (Collider.units) in groups of one kind that share their hulls
    or heightmap, each group as one batched op."""

    def __init__(self, collider: Collider):
        self.collider = collider
        self.slots = collider.slots
        collider.check_uncapped()
        ba, bb, mu, e = [], [], [], []
        for slot in self.slots:
            k = slot.n_slots
            ba += [slot.body_a] * k
            bb += [slot.body_b] * k
            mu += [min(slot.shape_a.friction, slot.shape_b.friction)] * k
            e += [slot.shape_a.restitution * slot.shape_b.restitution] * k
        self.body_a = np.asarray(ba, dtype=np.int32)
        self.body_b = np.asarray(bb, dtype=np.int32)
        self.mu = np.asarray(mu)
        self.restitution = np.asarray(e)
        self.num_contacts = collider.num_contacts
        # Contact positions of each group's outputs, in unit order.
        self.units = [u for _, u in collider.units]
        first = np.cumsum([0] + [u.n_slots for u in self.units])
        self._groups: Dict[tuple, List[int]] = {}
        for i, unit in enumerate(self.units):
            self._groups.setdefault(_group_key(unit), []).append(i)
        order = []
        for idx in self._groups.values():
            for i in idx:
                order += list(range(first[i], first[i + 1]))
        self._inv_order = np.argsort(np.asarray(order, dtype=np.int64))
        self._tensors: Dict[Tuple, dict] = {}

    def _consts(self, dtype, device) -> dict:
        key = (dtype, torch.device(device))
        if key in self._tensors:
            return self._tensors[key]

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        _statics(dtype, torch.device(device))  # the kinds' shared constants
        out = {"inv_order": torch.as_tensor(self._inv_order, device=device)}
        for gkey, idx in self._groups.items():
            kind = gkey[0]
            units = [self.units[i] for i in idx]
            Ta = np.stack([u.shape_a.T_offset for u in units])
            Tb = np.stack([u.shape_b.T_offset for u in units])
            c = dict(
                body_a=[u.body_a for u in units],
                body_b=[u.body_b for u in units],
                Ra_off=t(Ta[:, :3, :3])[..., None],
                pa_off=t(Ta[:, :3, 3])[..., None],
                Rb_off=t(Tb[:, :3, :3])[..., None],
                pb_off=t(Tb[:, :3, 3])[..., None],
            )
            if kind.endswith("_plane"):
                plane = np.stack(
                    [np.asarray(u.shape_b.size, np.float64).reshape(-1) for u in units]
                )
                n_local = plane[:, :3] / np.linalg.norm(plane[:, :3], axis=1)[:, None]
                d_local = plane[:, 3] if plane.shape[1] > 3 else np.zeros(len(units))
                c.update(n_local=t(n_local)[..., None], d_local=t(d_local)[:, None])
            kind_a, kind_b = kind.split("_")
            for side, shape_kind in (("a", kind_a), ("b", kind_b)):
                shapes = [getattr(u, f"shape_{side}") for u in units]
                if shape_kind == "sphere":
                    c[f"radius_{side}"] = t([_sphere_radius(x) for x in shapes])[:, None, None]
                elif shape_kind == "capsule":
                    c[f"radius_{side}"] = t([float(x.size[0]) for x in shapes])[:, None, None]
                    c[f"height_{side}"] = t([float(x.size[1]) for x in shapes])[:, None, None]
                elif shape_kind == "box":
                    c[f"half_{side}"] = t([np.asarray(x.size) / 2.0 for x in shapes])[..., None]
                elif shape_kind == "mesh":
                    hull = getattr(units[0], f"hull_{side}")
                    c[f"hull_{side}"] = hull.tensors(dtype, device)
                    c[f"k_{side}"] = min(8 if kind == "mesh_plane" else 4, len(hull.verts))
                elif shape_kind == "heightmap":
                    c["hm"] = Heightmap.of(t(shapes[0].heights), shapes[0].size)
            out[gkey] = c
        self._tensors[key] = out
        return out

    @staticmethod
    def _shape_T(R_wb, p_wb, bodies, R_off, p_off):
        R_body = torch.stack([R_wb[b] for b in bodies])  # (S, 3, 3, B)
        p_body = torch.stack([p_wb[b] for b in bodies])  # (S, 3, B)
        R = torch.einsum("sijb,sjkb->sikb", R_body, R_off)
        p = torch.einsum("sijb,sjb->sib", R_body, p_off) + p_body
        return R, p

    @staticmethod
    def _eval(kind, c, B, Ra, pa, Rb, pb):
        """One group's contacts: (m S, 3, B), (m S, 3, B), (m S, B)."""
        if kind == "box_box":
            return box_box_b(Ra, pa, c["half_a"], Rb, pb, c["half_b"])
        if kind == "sphere_sphere":
            return sphere_sphere_b(pa, c["radius_a"], pb, c["radius_b"])
        if kind == "sphere_box":
            return sphere_box_b(pa, c["radius_a"], Rb, pb, c["half_b"])
        if kind == "capsule_sphere":
            return capsule_sphere_b(Ra, pa, c["radius_a"], c["height_a"], pb, c["radius_b"])
        if kind == "capsule_capsule":
            return capsule_capsule_b(Ra, pa, c["radius_a"], c["height_a"], Rb, pb,
                                     c["radius_b"], c["height_b"])
        if kind == "capsule_box":
            return capsule_box_b(Ra, pa, c["radius_a"], c["height_a"], Rb, pb, c["half_b"])
        if kind == "sphere_mesh":
            return _per_slot(functools.partial(convex.sphere_mesh_flat, c["hull_b"]), B,
                             pa, c["radius_a"][:, 0], Rb, pb)
        if kind == "capsule_mesh":
            return _per_slot(functools.partial(convex.capsule_mesh_flat, c["hull_b"]), B,
                             Ra, pa, c["radius_a"][:, 0], c["height_a"][:, 0], Rb, pb)
        if kind == "box_mesh":
            return _per_slot(functools.partial(convex.box_mesh_flat, c["hull_b"], c["k_b"]),
                             B, Ra, pa, c["half_a"], Rb, pb)
        if kind == "mesh_mesh":
            return _per_slot(functools.partial(convex.mesh_mesh_flat, c["hull_a"], c["hull_b"],
                                               c["k_a"], c["k_b"]), B, Ra, pa, Rb, pb)
        if kind == "sphere_heightmap":
            return _per_slot(functools.partial(_sphere_heightmap_flat, c["hm"]), B,
                             pa, c["radius_a"][:, 0], Rb, pb)
        if kind == "capsule_heightmap":
            return _per_slot(functools.partial(_capsule_heightmap_flat, c["hm"]), B,
                             Ra, pa, c["radius_a"][:, 0], c["height_a"][:, 0], Rb, pb)
        if kind == "box_heightmap":
            return _per_slot(functools.partial(_box_heightmap_flat, c["hm"]), B,
                             Ra, pa, c["half_a"], Rb, pb)
        n_w = torch.einsum("sijb,sjb->sib", Rb, c["n_local"])
        d_w = c["d_local"] + torch.sum(n_w * pb, dim=1)
        if kind == "capsule_plane":
            return capsule_plane_b(Ra, pa, c["radius_a"], c["height_a"], n_w, d_w)
        if kind == "box_plane":
            return box_plane_b(Ra, pa, c["half_a"], n_w, d_w)
        if kind == "mesh_plane":
            return _per_slot(functools.partial(convex.mesh_plane_flat, c["hull_a"], c["k_a"]),
                             B, Ra, pa, n_w, d_w)
        return sphere_plane_b(pa, c["radius_a"], n_w, d_w)

    def collide(self, R_wb: List, p_wb: List, B: int):
        """All slots -> (point (C,3,B), normal (C,3,B), depth (C,B))."""
        dtype, device = R_wb[0].dtype, R_wb[0].device
        if not self.slots:
            return (
                torch.zeros(0, 3, B, dtype=dtype, device=device),
                torch.zeros(0, 3, B, dtype=dtype, device=device),
                torch.zeros(0, B, dtype=dtype, device=device),
            )
        consts = self._consts(dtype, device)
        pts, nrms, deps = [], [], []
        for gkey in self._groups:
            c = consts[gkey]
            Ra, pa = self._shape_T(R_wb, p_wb, c["body_a"], c["Ra_off"], c["pa_off"])
            Rb, pb = self._shape_T(R_wb, p_wb, c["body_b"], c["Rb_off"], c["pb_off"])
            p, n, d = self._eval(gkey[0], c, B, Ra, pa, Rb, pb)
            pts.append(p)
            nrms.append(-n if gkey[1] else n)
            deps.append(d)
        inv = consts["inv_order"]
        return (
            torch.cat(pts)[inv],
            torch.cat(nrms)[inv],
            torch.cat(deps)[inv],
        )

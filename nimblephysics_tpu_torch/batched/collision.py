"""Batched narrowphase: the collider's static slot plan evaluated with the
world batch in the trailing axis.

Counterpart of nimblephysics_tpu/batched/collision.py for the pair kinds
of the half-cheetah and box-stack worlds: sphere-plane, capsule-plane,
box-plane and box-box (formula parity with sphere_plane_b,
capsule_plane_b, box_plane_b and box_box_b there). All slots of one kind
are evaluated together as one batched op. Per-contact outputs: point
(C, 3, B), normal (C, 3, B), depth (C, B), in slot order.

box_box_b is the clipped separating-axis manifold (DARTCollide.cpp:1452
dBoxBox re-designed): 15 axes scored, the best face of either box clipped
against the other's incident face, or one edge-edge contact, in 8 slots
whose unused entries have depth -1. Inside, a kind's slots are flattened
into the batch axis, (3, S B), so that every formula reads as the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.batched import linalg as bl
from nimblephysics_tpu_torch.collision.collider import Collider, _sphere_radius

_NATIVE = ("sphere_plane", "capsule_plane", "box_plane", "box_box")
_PLANE_KINDS = ("sphere_plane", "capsule_plane", "box_plane")


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


_BOX_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
)


def box_plane_b(R_box, p_box, half, n_w, d_w):
    """The 8 corners of boxes against planes: R_box (S, 3, 3, B), p_box
    (S, 3, B), half sizes (S, 3, 1), plane normal (S, 3, B) and offset
    (S, B) -> contacts ordered by corner per slot: (8S, 3, B), (8S, B)."""
    S, B = p_box.shape[0], p_box.shape[-1]
    signs = torch.as_tensor(_BOX_SIGNS, dtype=p_box.dtype, device=p_box.device)
    local = signs[None, :, :, None] * half[:, None]  # (S, 8, 3, 1)
    corner = torch.einsum("sijb,skjb->skib", R_box, local) + p_box[:, None]
    depth = -(torch.sum(corner * n_w[:, None], dim=2) - d_w[:, None])  # (S, 8, B)
    point = corner + 0.5 * depth[:, :, None] * n_w[:, None]
    normal = n_w[:, None].expand(S, 8, 3, B)
    return point.reshape(8 * S, 3, B), normal.reshape(8 * S, 3, B), depth.reshape(8 * S, B)


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

    cs = [(1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0)]
    corners3d = torch.stack(
        [inc_center + su * hi_u * iu + sv * hi_v * iv for su, sv in cs]
    )  # (4, 3, N)
    rel = corners3d - face_origin[None]
    quad = torch.stack(
        [torch.sum(rel * u[None], dim=1), torch.sum(rel * v[None], dim=1)], dim=1
    )  # (4, 2, N)
    rect = torch.as_tensor(cs, dtype=dtype, device=p_r.device)[:, :, None] * (
        torch.stack([h_u, h_v])[None]
    )  # (4, 2, N)

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

    seps, world_axes, penalties = [], [], []
    for i in range(3):  # face axes of A
        seps.append(torch.abs(t[i]) - (h_a[i] + torch.sum(absC[i] * h_b, dim=0)))
        world_axes.append(R_a[:, i] * _sign(t[i]))
        penalties.append(0.0)
    tb = bl.mtv(C, t)  # the centre offset in B's frame
    for j in range(3):  # face axes of B
        seps.append(torch.abs(tb[j]) - (h_b[j] + torch.sum(absC[:, j] * h_a, dim=0)))
        world_axes.append(R_b[:, j] * _sign(tb[j]))
        penalties.append(0.0)
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
            penalties.append(1e-4)

    seps_arr = torch.stack(seps)  # (15, N)
    axes_arr = torch.stack(world_axes)  # (15, 3, N)
    score = seps_arr - torch.as_tensor(penalties, dtype=dtype, device=p_a.device)[:, None]
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


class BatchedCollider:
    """Evaluates a Collider's static slot plan on a world batch."""

    def __init__(self, collider: Collider):
        self.collider = collider
        self.slots = collider.slots
        for slot in self.slots:
            if slot.kind not in _NATIVE:
                raise NotImplementedError(
                    f"batched collision kind {slot.kind!r} comes with the "
                    "rest of the batched engine (ROADMAP queue 1 item 9)"
                )
        n_all = sum(s.n_slots for s in self.slots)
        if collider.num_contacts != n_all:
            raise NotImplementedError(
                "World.max_contacts below the slot count is not supported "
                "by the batched engine"
            )
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
        # Contact positions of each kind's outputs, in slot order.
        first = np.cumsum([0] + [s.n_slots for s in self.slots])
        self._groups: Dict[str, List[int]] = {}
        for i, slot in enumerate(self.slots):
            self._groups.setdefault(slot.kind, []).append(i)
        order = []
        for kind, idx in self._groups.items():
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

        out = {"inv_order": torch.as_tensor(self._inv_order, device=device)}
        for kind, idx in self._groups.items():
            slots = [self.slots[i] for i in idx]
            Ta = np.stack([s.shape_a.T_offset for s in slots])
            Tb = np.stack([s.shape_b.T_offset for s in slots])
            c = dict(
                body_a=[s.body_a for s in slots],
                body_b=[s.body_b for s in slots],
                Ra_off=t(Ta[:, :3, :3])[..., None],
                pa_off=t(Ta[:, :3, 3])[..., None],
                Rb_off=t(Tb[:, :3, :3])[..., None],
                pb_off=t(Tb[:, :3, 3])[..., None],
            )
            if kind in _PLANE_KINDS:
                plane = np.stack(
                    [np.asarray(s.shape_b.size, np.float64).reshape(-1) for s in slots]
                )
                n_local = plane[:, :3] / np.linalg.norm(plane[:, :3], axis=1)[:, None]
                d_local = plane[:, 3] if plane.shape[1] > 3 else np.zeros(len(slots))
                c.update(n_local=t(n_local)[..., None], d_local=t(d_local)[:, None])
            if kind in ("sphere_plane", "capsule_plane"):
                c["radius"] = t([_sphere_radius(s.shape_a) for s in slots])[:, None, None]
            if kind == "capsule_plane":
                c["height"] = t([float(s.shape_a.size[1]) for s in slots])[:, None, None]
            if kind in ("box_plane", "box_box"):
                c["half_a"] = t([np.asarray(s.shape_a.size) / 2.0 for s in slots])[..., None]
            if kind == "box_box":
                c["half_b"] = t([np.asarray(s.shape_b.size) / 2.0 for s in slots])[..., None]
            out[kind] = c
        self._tensors[key] = out
        return out

    @staticmethod
    def _shape_T(R_wb, p_wb, bodies, R_off, p_off):
        R_body = torch.stack([R_wb[b] for b in bodies])  # (S, 3, 3, B)
        p_body = torch.stack([p_wb[b] for b in bodies])  # (S, 3, B)
        R = torch.einsum("sijb,sjkb->sikb", R_body, R_off)
        p = torch.einsum("sijb,sjb->sib", R_body, p_off) + p_body
        return R, p

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
        for kind in self._groups:
            c = consts[kind]
            Ra, pa = self._shape_T(R_wb, p_wb, c["body_a"], c["Ra_off"], c["pa_off"])
            Rb, pb = self._shape_T(R_wb, p_wb, c["body_b"], c["Rb_off"], c["pb_off"])
            if kind == "box_box":
                out = box_box_b(Ra, pa, c["half_a"], Rb, pb, c["half_b"])
            else:
                n_w = torch.einsum("sijb,sjb->sib", Rb, c["n_local"])
                d_w = c["d_local"] + torch.sum(n_w * pb, dim=1)
                if kind == "capsule_plane":
                    out = capsule_plane_b(Ra, pa, c["radius"], c["height"], n_w, d_w)
                elif kind == "box_plane":
                    out = box_plane_b(Ra, pa, c["half_a"], n_w, d_w)
                else:
                    out = sphere_plane_b(pa, c["radius"], n_w, d_w)
            pts.append(out[0])
            nrms.append(out[1])
            deps.append(out[2])
        inv = consts["inv_order"]
        return (
            torch.cat(pts)[inv],
            torch.cat(nrms)[inv],
            torch.cat(deps)[inv],
        )

"""Convex-mesh collision: the hull built at plan time, and the mesh pairs'
narrowphase with the world batch in the trailing axis.

Counterpart of nimblephysics_tpu/collision/convex.py. The plan-time part
is numpy and the JAX package's own arithmetic (decimate_support,
hull_faces, ConvexHull.build, hull_triangles), copied here: a mesh is
decimated to the support points of a static direction fan and its hull's
faces enumerated brute force. Contacts are vertex/face based with fixed
slot counts: hull vertices against a plane or a box, points against the
hull's face planes (exact inside), the k deepest kept. The k deepest are
taken by a stable descending sort, so that equal depths (a flat face at
rest) keep the lower index first, as jax.lax.top_k does.

The *_flat functions take their pairs flattened into the batch axis, as
batched/collision.py's do: rotations (3, 3, N), positions (3, N), and
return points (k, 3, N), normals (k, 3, N), depths (k, N); the hull's
tensors come from ConvexHull.tensors. Normals point from body B to body
A, depth > 0 is penetration.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.batched import linalg as bl

_EPS = 1e-12
_BOX_SIGNS = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
# capsule_mesh's samples along the axis, in heights.
_CAPSULE_SAMPLES = (-0.5, -0.25, 0.0, 0.25, 0.5)


# ---------------------------------------------------------------------------
# Plan time (numpy)
# ---------------------------------------------------------------------------


def _direction_fan(n_theta: int = 8, n_phi: int = 6) -> np.ndarray:
    """Static quasi-uniform direction set (+ axis directions)."""
    dirs = [
        [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
    ]
    for i in range(n_phi):
        phi = np.pi * (i + 0.5) / n_phi
        for j in range(n_theta):
            th = 2 * np.pi * j / n_theta
            dirs.append(
                [np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th), np.cos(phi)]
            )
    return np.asarray(dirs, dtype=np.float64)


def decimate_support(verts: np.ndarray, max_verts: int = 40) -> np.ndarray:
    """Keep the support points of a static direction fan (approximate hull
    vertex set, <= max_verts)."""
    verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    if len(verts) <= max_verts:
        return verts
    dirs = _direction_fan()
    idx = np.unique(np.argmax(verts @ dirs.T, axis=0))
    out = verts[idx]
    if len(out) > max_verts:
        # Greedy farthest-point thinning.
        keep = [0]
        d = np.linalg.norm(out - out[0], axis=1)
        for _ in range(max_verts - 1):
            k = int(np.argmax(d))
            keep.append(k)
            d = np.minimum(d, np.linalg.norm(out - out[k], axis=1))
        out = out[sorted(set(keep))]
    return out


def hull_faces(verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Outward face planes of the convex hull of a small point set: a
    triple spans a hull face iff every point lies on one side of its
    plane (O(n^4), plan time only, n <= ~40). Returns (normals (F, 3),
    offsets (F,)) with hull = {x : normals @ x <= offsets}, coplanar
    duplicates merged."""
    V = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    n = len(V)
    assert n >= 4, "need at least 4 points for a 3D hull"
    c = V.mean(axis=0)
    planes = []
    for i in range(n):
        for j in range(i + 1, n):
            for k in range(j + 1, n):
                nrm = np.cross(V[j] - V[i], V[k] - V[i])
                ln = np.linalg.norm(nrm)
                if ln < 1e-12:
                    continue
                nrm = nrm / ln
                d = nrm @ V[i]
                side = V @ nrm - d
                if side.max() <= 1e-9:
                    planes.append((nrm, d))
                elif side.min() >= -1e-9:
                    planes.append((-nrm, -d))
    if not planes:
        raise ValueError("degenerate (planar) point set — no 3D hull")
    N = np.asarray([p[0] for p in planes])
    D = np.asarray([p[1] for p in planes])
    # Merge duplicates (same plane found from many coplanar triples).
    key = np.round(np.concatenate([N, D[:, None]], axis=1), 7)
    _, idx = np.unique(key, axis=0, return_index=True)
    N, D = N[sorted(idx)], D[sorted(idx)]
    assert (N @ c - D).max() < 0, "hull face orientation failed"
    return N, D


@dataclasses.dataclass(frozen=True, eq=False)
class ConvexHull:
    """Static hull data of one mesh shape."""

    verts: np.ndarray  # (V, 3) decimated hull vertices (shape frame)
    face_n: np.ndarray  # (F, 3) outward unit normals
    face_d: np.ndarray  # (F,) offsets: inside <=> face_n @ x <= face_d
    _tensors: Dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def build(mesh_vertices, max_verts: int = 40) -> "ConvexHull":
        v = decimate_support(mesh_vertices, max_verts=max_verts)
        N, D = hull_faces(v)
        return ConvexHull(verts=v, face_n=N, face_d=D)

    def tensors(self, dtype, device):
        """(verts (V, 3), face_n (F, 3), face_d (F, 1)) as tensors, built
        once per dtype and device."""
        key = (dtype, torch.device(device))
        if key not in self._tensors:
            self._tensors[key] = tuple(
                torch.as_tensor(a, dtype=dtype, device=device)
                for a in (self.verts, self.face_n, self.face_d[:, None]))
        return self._tensors[key]


def hull_triangles(verts: np.ndarray) -> np.ndarray:
    """Triangle index list of the hull surface (plan time, for display);
    coplanar faces yield a fan of coplanar triangles."""
    V = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    n = len(V)
    tris = []
    for i in range(n):
        for j in range(i + 1, n):
            for k in range(j + 1, n):
                nrm = np.cross(V[j] - V[i], V[k] - V[i])
                ln = np.linalg.norm(nrm)
                if ln < 1e-12:
                    continue
                side = (V - V[i]) @ (nrm / ln)
                if side.max() <= 1e-9 or side.min() >= -1e-9:
                    tris.append((i, j, k))
    return np.asarray(tris, dtype=np.int64).reshape(-1, 3)


# ---------------------------------------------------------------------------
# Narrowphase, pairs flattened into the batch axis
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _box_signs(dtype, device):
    """The 8 corner signs of a box, (8, 3), built once per dtype and
    device."""
    return torch.as_tensor(_BOX_SIGNS, dtype=dtype, device=device)


def _topk(points, normals, depths, k):
    """The k deepest of M candidates (M, 3, N), (M, 3, N), (M, N), deepest
    first, equal depths in index order."""
    idx = torch.sort(depths, dim=0, descending=True, stable=True).indices[:k]
    i3 = idx[:, None, :].expand(k, 3, idx.shape[-1])
    return points.gather(0, i3), normals.gather(0, i3), depths.gather(0, idx)


def _world_verts(R, p, verts):
    """Hull vertices (V, 3) placed at every pose: (V, 3, N)."""
    return torch.einsum("ijn,vj->vin", R, verts) + p[None]


def _hull_sdf(x_local, face_n, face_d):
    """The hull's face-plane distance at points (..., 3, N) in its frame:
    (phi (..., N), the outward normal of the maximizing face (..., 3, N));
    exact inside the hull."""
    phi_f = torch.einsum("fj,...jn->...fn", face_n, x_local) - face_d  # (..., F, N)
    i = torch.argmax(phi_f, dim=-2, keepdim=True)
    phi = torch.gather(phi_f, -2, i).squeeze(-2)
    n_local = face_n[i.squeeze(-2)]  # (..., N, 3)
    return phi, n_local.movedim(-1, -2)


def mesh_plane_flat(hull, k, R_m, p_m, n_w, d_w):
    """Mesh (A) against a plane (B): its vertices below the plane, the
    k = min(8, V) deepest."""
    verts, _, _ = hull
    Vw = _world_verts(R_m, p_m, verts)
    depths = -(torch.sum(Vw * n_w[None], dim=1) - d_w)
    points = Vw + 0.5 * depths[:, None] * n_w[None]
    return _topk(points, n_w[None].expand_as(Vw), depths, k)


def sphere_mesh_flat(hull, c, radius, R_m, p_m):
    """Sphere (A) against a mesh (B): 1 slot by the hull's face planes at
    the centre."""
    _, face_n, face_d = hull
    phi, n_local = _hull_sdf(bl.mtv(R_m, c - p_m), face_n, face_d)
    n_world = bl.mv(R_m, n_local)
    depth = radius - phi
    point = c - n_world * (radius - 0.5 * depth)
    return point[None], n_world[None], depth[None]


def capsule_mesh_flat(hull, R_cap, p_cap, radius, height, R_m, p_m, k=3):
    """Capsule (A) against a mesh (B): the hull's face planes at 5 points
    along the axis, the k deepest."""
    _, face_n, face_d = hull
    axis = R_cap[:, 2]
    pts = torch.stack([p_cap + axis * (t * height) for t in _CAPSULE_SAMPLES])  # (5, 3, N)
    phi, n_local = _hull_sdf(torch.einsum("jin,sjn->sin", R_m, pts - p_m[None]), face_n, face_d)
    n_world = torch.einsum("ijn,sjn->sin", R_m, n_local)
    depth = radius - phi
    points = pts - n_world * (radius - 0.5 * depth)[:, None]
    return _topk(points, n_world, depth, k)


def box_mesh_flat(hull, k_verts, R_b, p_b, half, R_m, p_m, k=4):
    """Box (A) against a mesh (B): the box corners against the hull's face
    planes (the k deepest) and the hull vertices against the box (the
    k_verts = min(4, V) deepest)."""
    verts, face_n, face_d = hull
    signs = _box_signs(p_b.dtype, p_b.device)
    corners = torch.einsum("ijn,cjn->cin", R_b, signs[:, :, None] * half[None]) + p_b[None]
    phi, n_local = _hull_sdf(torch.einsum("jin,cjn->cin", R_m, corners - p_m[None]),
                             face_n, face_d)
    n_world = torch.einsum("ijn,cjn->cin", R_m, n_local)  # mesh -> box, B -> A
    depth = -phi
    p1, n1, d1 = _topk(corners + 0.5 * depth[:, None] * n_world, n_world, depth, k)
    # Hull vertices into the box: the box's outward face normal at each,
    # negated (B -> A).
    Vw = _world_verts(R_m, p_m, verts)
    local = torch.einsum("jin,vjn->vin", R_b, Vw - p_b[None])
    qd = torch.abs(local) - half[None]
    onehot = torch.nn.functional.one_hot(torch.argmax(qd, dim=1), 3).movedim(-1, 1).to(local.dtype)
    depth_v = -torch.amax(qd, dim=1)
    sgn = torch.sign(torch.sum(local * onehot, dim=1) + _EPS)
    n_world_v = -torch.einsum("ijn,vjn->vin", R_b, onehot * sgn[:, None])
    p2, n2, d2 = _topk(Vw - 0.5 * depth_v[:, None] * n_world_v, n_world_v, depth_v, k_verts)
    return torch.cat([p1, p2]), torch.cat([n1, n2]), torch.cat([d1, d2])


def _verts_into_hull(hull_m, k, R_m, p_m, hull_o, R_o, p_o, flip):
    """Mesh m's vertices against mesh o's face planes, the k deepest; the
    normal is o's outward face normal, negated when flip (o is body A)."""
    Vw = _world_verts(R_m, p_m, hull_m[0])
    _, face_n, face_d = hull_o
    phi, n_local = _hull_sdf(torch.einsum("jin,vjn->vin", R_o, Vw - p_o[None]), face_n, face_d)
    n_out = torch.einsum("ijn,vjn->vin", R_o, n_local)
    depth = -phi
    pts = Vw + 0.5 * depth[:, None] * n_out
    return _topk(pts, -n_out if flip else n_out, depth, k)


def mesh_mesh_flat(hull_a, hull_b, k_a, k_b, R_a, p_a, R_b, p_b):
    """Mesh (A) against mesh (B): A's vertices in B's hull (the k_a =
    min(4, V_a) deepest), then B's vertices in A's hull (k_b)."""
    outs = (_verts_into_hull(hull_a, k_a, R_a, p_a, hull_b, R_b, p_b, False),
            _verts_into_hull(hull_b, k_b, R_b, p_b, hull_a, R_a, p_a, True))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))

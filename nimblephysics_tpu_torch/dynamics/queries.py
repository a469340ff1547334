"""Differentiable skeleton geometry queries: height, lowest point, marker
distance to shape vertices.

Counterpart of nimblephysics_tpu/dynamics/queries.py (reference:
Skeleton::getHeight, Skeleton::getLowestPoint and
BodyNode::getDistToClosestVerticesToMarker with their gradients). Each
query is a torch function of (q, body_scales) over a static per-body
vertex table taken from the skeleton's shapes (mesh vertices as they
are; extremal vertices for primitives), through the body-scaled
forward kinematics; autograd gives the gradients, the max/min picking
the extremal vertex's (the reference's subgradient).

Tensors run where they lie; q or body_scales given as numpy or None go
to `device`, the card unless device="cpu", in float64.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.biomechanics.scaled_fk import scaled_forward_kinematics
from nimblephysics_tpu_torch.dynamics import shapes as SH
from nimblephysics_tpu_torch.dynamics.skeleton import Skeleton


def _primitive_vertices(spec: SH.ShapeSpec) -> Optional[np.ndarray]:
    """Representative local-frame vertices of a shape (pre body-scale)."""
    t = spec.shape_type
    s = np.asarray(spec.size, dtype=np.float64)
    if t == SH.MESH and spec.mesh_vertices is not None:
        return np.asarray(spec.mesh_vertices, dtype=np.float64)
    if t == SH.BOX:
        h = s[:3] / 2.0
        corners = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            dtype=np.float64,
        )
        return corners * h
    if t == SH.SPHERE:
        r = s[0]
        return r * np.concatenate([np.eye(3), -np.eye(3)])
    if t == SH.ELLIPSOID:
        half = s[:3] / 2.0
        return np.concatenate([np.diag(half), -np.diag(half)])
    if t in (SH.CAPSULE, SH.CYLINDER):
        r, h = s[0], s[1]
        ang = np.linspace(0.0, 2 * np.pi, 8, endpoint=False)
        rim = np.stack(
            [r * np.cos(ang), r * np.sin(ang), np.zeros_like(ang)], axis=1
        )
        top = rim + np.array([0.0, 0.0, h / 2.0])
        bot = rim - np.array([0.0, 0.0, h / 2.0])
        tips = np.array([[0, 0, h / 2.0], [0, 0, -h / 2.0]])
        if t == SH.CAPSULE:
            tips = np.array([[0, 0, h / 2.0 + r], [0, 0, -h / 2.0 - r]])
        return np.concatenate([top, bot, tips])
    if t == SH.CONE:
        r, h = s[0], s[1]
        ang = np.linspace(0.0, 2 * np.pi, 8, endpoint=False)
        base = np.stack(
            [r * np.cos(ang), r * np.sin(ang), np.full_like(ang, -h / 2.0)],
            axis=1,
        )
        return np.concatenate([base, np.array([[0.0, 0.0, h / 2.0]])])
    if t == SH.MULTI_SPHERE and spec.spheres is not None:
        pts = []
        for cx, cy, cz, r in np.asarray(spec.spheres, dtype=np.float64):
            pts.append(np.array([cx, cy, cz]) + r * np.eye(3))
            pts.append(np.array([cx, cy, cz]) - r * np.eye(3))
        return np.concatenate(pts)
    return None  # planes / heightmaps / display-only types


def body_vertex_table(
    skel: Skeleton, mesh_only: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Static (verts (N, 3) in body frame pre-scale, body_index (N,)).

    mesh_only mirrors the reference getHeight() restriction to MeshShapes;
    with mesh_only=False primitives contribute analytic extremal vertices
    (a strict superset of the reference's capability).
    """
    all_v: List[np.ndarray] = []
    all_b: List[np.ndarray] = []
    for bi, spec in enumerate(skel.bodies):
        for sh in spec.shapes:
            if mesh_only and sh.shape_type != SH.MESH:
                continue
            v = _primitive_vertices(sh)
            if v is None or len(v) == 0:
                continue
            R, p = sh.T_offset[:3, :3], sh.T_offset[:3, 3]
            v_body = v @ R.T + p  # body frame, pre body-scale
            all_v.append(v_body)
            all_b.append(np.full(len(v_body), bi, dtype=np.int32))
    if not all_v:
        return np.zeros((0, 3)), np.zeros((0,), dtype=np.int32)
    return np.concatenate(all_v), np.concatenate(all_b)


def _inputs(skel: Skeleton, q, body_scales, device):
    """q (nv,) and body_scales (nb, 3) or None as tensors: tensors stay
    where they lie, the rest go to `device` (the card unless "cpu")."""
    from nimblephysics_tpu_torch.batched.engine import _resolve_device

    ref = next((x for x in (q, body_scales) if isinstance(x, torch.Tensor)), None)
    if ref is None:
        dev, dt = _resolve_device(device), torch.float64
    else:
        dev, dt = ref.device, ref.dtype
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"inputs lie on {dev}, not on {device}")
    if q is None:
        q = np.zeros(skel.num_dofs)
    q = torch.as_tensor(q, dtype=dt, device=dev) if not isinstance(q, torch.Tensor) else q
    if body_scales is not None and not isinstance(body_scales, torch.Tensor):
        body_scales = torch.as_tensor(body_scales, dtype=dt, device=dev)
    for x in (q, body_scales):
        if x is not None and x.device != dev:
            raise ValueError(f"q and body_scales lie on {q.device} and {x.device}; "
                             "the queries copy nothing")
    return q, body_scales


def _world_vertices(skel: Skeleton, q, body_scales, table) -> torch.Tensor:
    verts, bodies = table
    if len(verts) == 0:
        raise ValueError(
            "skeleton has no shape vertices for geometry queries "
            "(reference getHeight() would throw here too)"
        )
    T = scaled_forward_kinematics(skel, q, body_scales)
    idx = torch.as_tensor(bodies, dtype=torch.long, device=q.device)
    Tb = T[idx]  # (N, 4, 4)
    local = torch.as_tensor(verts, dtype=q.dtype, device=q.device)
    if body_scales is not None:
        local = local * body_scales[idx]
    return torch.einsum("nij,nj->ni", Tb[:, :3, :3], local) + Tb[:, :3, 3]


def _heights(skel, q, body_scales, up, table, device):
    q, body_scales = _inputs(skel, q, body_scales, device)
    table = body_vertex_table(skel) if table is None else table
    w = _world_vertices(skel, q, body_scales, table)
    return w @ torch.as_tensor(np.asarray(up, dtype=np.float64), dtype=q.dtype, device=q.device)


def skeleton_height(
    skel: Skeleton,
    q=None,
    body_scales=None,
    up: Sequence = (0.0, 1.0, 0.0),
    table: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device=None,
) -> torch.Tensor:
    """max(up . v) - min(up . v) over all shape vertices (world frame),
    differentiable in q and body_scales (reference: Skeleton::getHeight
    and getGradientOfHeightWrtBodyScales). q None: the zero pose."""
    d = _heights(skel, q, body_scales, up, table, device)
    return torch.max(d) - torch.min(d)


def skeleton_lowest_point(
    skel: Skeleton,
    q=None,
    body_scales=None,
    up: Sequence = (0.0, 1.0, 0.0),
    table: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device=None,
) -> torch.Tensor:
    """min(up . v) over all shape vertices (Skeleton::getLowestPoint)."""
    return torch.min(_heights(skel, q, body_scales, up, table, device))


def marker_dist_to_nearest_vertex(
    skel: Skeleton,
    body_index: int,
    marker_offset,
    body_scale,
    device=None,
) -> torch.Tensor:
    """Distance from a body-local marker to the nearest shape vertex of
    that body, both under `body_scale` (3,) (reference:
    BodyNode::getDistToClosestVerticesToMarker and its body-scale and
    marker-offset gradients). FK-independent (body-local)."""
    verts, bodies = body_vertex_table(skel)
    v_local = verts[bodies == body_index]
    if len(v_local) == 0:
        raise ValueError(f"body {body_index} has no shape vertices")
    marker_offset, body_scale = _inputs(skel, marker_offset, body_scale, device)
    v = torch.as_tensor(v_local, dtype=marker_offset.dtype,
                        device=marker_offset.device) * body_scale[None, :]
    m = marker_offset * body_scale
    d2 = torch.sum((v - m[None, :]) ** 2, dim=1)
    return torch.sqrt(torch.clamp(torch.min(d2), min=1e-18))

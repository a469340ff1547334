"""Raycasts against a world's shapes.

Counterpart of nimblephysics_tpu/collision/raycast.py: analytic ray tests
against spheres (and ellipsoids as spheres), planes, boxes (slabs) and
capsules (cylinders and cones as capsules, by 9 spheres along the axis),
the nearest hit over a static shape list. Differentiable in q, the
origin and the direction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nimblephysics_tpu_torch.dynamics import shapes as SH
from nimblephysics_tpu_torch.simulation.world import World, world_fk

_BIG = 1e10


class RayHit(NamedTuple):
    """The nearest hit (reference: collision::RaycastResult)."""

    hit: torch.Tensor  # bool
    fraction: torch.Tensor  # distance along the (unit) ray
    point: torch.Tensor  # (3,)
    normal: torch.Tensor  # (3,)
    body: torch.Tensor  # int64 global body index (-1 = none)


def _safe_unit(v):
    return v / torch.sqrt(torch.clamp(torch.sum(v * v), min=1e-18))


def _ray_sphere(o, d, center, radius):
    oc = o - center
    b = torch.dot(oc, d)
    disc = b * b - (torch.dot(oc, oc) - radius * radius)
    t = -b - torch.sqrt(torch.clamp(disc, min=1e-18))
    t = torch.where((disc >= 0) & (t > 0), t, torch.full_like(t, _BIG))
    p = o + t * d
    return t, p, _safe_unit(p - center)


def _ray_plane(o, d, normal, offset):
    denom = torch.dot(normal, d)
    ok = torch.abs(denom) >= 1e-12
    t = (offset - torch.dot(normal, o)) / torch.where(ok, denom, torch.full_like(denom, 1e-12))
    t = torch.where(ok & (t > 0), t, torch.full_like(t, _BIG))
    return t, o + t * d, normal * torch.sign(-denom)


def _ray_box(o, d, T_box, half):
    """Slab method in the box frame."""
    R, c = T_box[:3, :3], T_box[:3, 3]
    ol = R.T @ (o - c)
    dl = R.T @ d
    inv = 1.0 / torch.where(torch.abs(dl) < 1e-12, torch.full_like(dl, 1e-12), dl)
    t1 = (-half - ol) * inv
    t2 = (half - ol) * inv
    tmin = torch.amax(torch.minimum(t1, t2))
    tmax = torch.amin(torch.maximum(t1, t2))
    hit = tmax >= torch.clamp(tmin, min=0.0)
    t = torch.where(hit & (tmin > 0), tmin, torch.full_like(tmin, _BIG))
    pl = ol + t * dl
    # The face normal: the axis where |p| is closest to its half extent.
    axis = torch.argmin(torch.abs(torch.abs(pl) - half))
    nl = torch.nn.functional.one_hot(axis, 3).to(pl.dtype) * torch.sign(pl[axis])
    return t, R @ pl + c, R @ nl


def _ray_capsule(o, d, T_cap, radius, height):
    """The nearest of 9 spheres along the axis segment."""
    z = T_cap[:3, 2]
    a = T_cap[:3, 3] - z * height / 2
    b = T_cap[:3, 3] + z * height / 2
    hits = [_ray_sphere(o, d, a + s * (b - a), radius) for s in np.linspace(0.0, 1.0, 9)]
    ts = torch.stack([h[0] for h in hits])
    k = torch.argmin(ts)
    return ts[k], torch.stack([h[1] for h in hits])[k], torch.stack([h[2] for h in hits])[k]


def raycast(world: World, q: torch.Tensor, origin: torch.Tensor,
            direction: torch.Tensor) -> RayHit:
    """Cast one ray against every collidable shape; the nearest hit wins.
    Shapes the ray tests do not cover (meshes, heightmaps, sphere sets)
    are skipped, as the JAX package skips them."""
    d = _safe_unit(direction)
    o = origin
    T_wb = world_fk(world, q)
    body_off = world.body_offsets()
    ts, ps, ns, bids = [], [], [], []
    for si, skel in enumerate(world.skeletons):
        for bi, body in enumerate(skel.bodies):
            gb = body_off[si] + bi
            for shape in body.shapes:
                if not shape.collidable:
                    continue
                T_ws = T_wb[gb] @ torch.as_tensor(shape.T_offset, dtype=q.dtype, device=q.device)
                st = shape.shape_type
                size = np.asarray(shape.size, dtype=np.float64)
                if st in (SH.SPHERE, SH.ELLIPSOID):
                    r = float(size[0]) if st == SH.SPHERE else float(size.mean() / 2)
                    t, p, nrm = _ray_sphere(o, d, T_ws[:3, 3], r)
                elif st == SH.BOX:
                    t, p, nrm = _ray_box(o, d, T_ws, torch.as_tensor(
                        size / 2, dtype=q.dtype, device=q.device))
                elif st == SH.PLANE:
                    params = size.reshape(-1)
                    n_w = T_ws[:3, :3] @ torch.as_tensor(
                        params[:3] / np.linalg.norm(params[:3]), dtype=q.dtype, device=q.device)
                    off = (params[3] if params.size > 3 else 0.0) + torch.dot(n_w, T_ws[:3, 3])
                    t, p, nrm = _ray_plane(o, d, n_w, off)
                elif st in (SH.CAPSULE, SH.CYLINDER, SH.CONE):
                    t, p, nrm = _ray_capsule(o, d, T_ws, float(size[0]), float(size[1]))
                else:
                    continue
                ts.append(t)
                ps.append(p)
                ns.append(nrm)
                bids.append(gb)
    if not ts:
        z3 = q.new_zeros(3)
        return RayHit(torch.tensor(False, device=q.device), q.new_tensor(_BIG), z3, z3,
                      torch.tensor(-1, device=q.device))
    tarr = torch.stack(ts)
    k = torch.argmin(tarr)
    hit = tarr[k] < _BIG * 0.5
    body = torch.as_tensor(bids, device=q.device)[k]
    return RayHit(hit, tarr[k], torch.stack(ps)[k], torch.stack(ns)[k],
                  torch.where(hit, body, torch.full_like(body, -1)))

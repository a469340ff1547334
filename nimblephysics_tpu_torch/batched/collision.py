"""Batched narrowphase: the collider's static slot plan evaluated with the
world batch in the trailing axis.

Counterpart of nimblephysics_tpu/batched/collision.py for the pair kinds
on the main path, sphere-plane and capsule-plane (formula parity with
sphere_plane_b and capsule_plane_b there). All slots of one kind are
evaluated together as one batched op. Per-contact outputs: point
(C, 3, B), normal (C, 3, B), depth (C, B), in slot order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.collision.collider import Collider, _sphere_radius

_NATIVE = ("sphere_plane", "capsule_plane")


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
            plane = np.stack(
                [np.asarray(s.shape_b.size, np.float64).reshape(-1) for s in slots]
            )
            n_local = plane[:, :3] / np.linalg.norm(plane[:, :3], axis=1)[:, None]
            d_local = plane[:, 3] if plane.shape[1] > 3 else np.zeros(len(slots))
            radius = [_sphere_radius(s.shape_a) for s in slots]
            height = [
                float(s.shape_a.size[1]) if kind == "capsule_plane" else 0.0
                for s in slots
            ]
            out[kind] = dict(
                body_a=[s.body_a for s in slots],
                body_b=[s.body_b for s in slots],
                Ra_off=t(Ta[:, :3, :3])[..., None],
                pa_off=t(Ta[:, :3, 3])[..., None],
                Rb_off=t(Tb[:, :3, :3])[..., None],
                pb_off=t(Tb[:, :3, 3])[..., None],
                n_local=t(n_local)[..., None],
                d_local=t(d_local)[:, None],
                radius=t(radius)[:, None, None],
                height=t(height)[:, None, None],
            )
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
            n_w = torch.einsum("sijb,sjb->sib", Rb, c["n_local"])
            d_w = c["d_local"] + torch.sum(n_w * pb, dim=1)
            if kind == "capsule_plane":
                out = capsule_plane_b(Ra, pa, c["radius"], c["height"], n_w, d_w)
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

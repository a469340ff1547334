"""Body-scaled forward kinematics and marker world positions.

Counterpart of nimblephysics_tpu/biomechanics/scaled_fk.py. A per-body
scale vector (3,) scales the joint anchors (T_pj's translation with the
parent body's scale, T_cj's with the child's) and the marker offsets:
the quantities marker fitting differentiates through.

Two forms:
  * one pose, q (nv,): `scaled_forward_kinematics` (nb, 4, 4) and
    `marker_world_positions` (M, 3), the batched forms with one frame;
  * frames in the trailing axis like worlds, q (nv, T):
    `scaled_forward_kinematics_frames` and `marker_world_positions_frames`
    run batched/articulated.py's fk on the skeleton's plan, and
    `marker_jacobians` gives the markers' derivatives in q, the body
    scales and the offsets in closed form from fk's world screw axes.
Everything is differentiable in (q, scales, offsets) by autograd.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from nimblephysics_tpu_torch.dynamics.skeleton import Skeleton, _fk, _plan, _transforms


def scaled_forward_kinematics(skel: Skeleton, q: torch.Tensor,
                              body_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """World transforms (nb, 4, 4) of one pose q (nv,), with per-body
    scales (nb, 3) in each body's frame applied to the joint anchors;
    None = all ones. The batched fk with a batch of one."""
    return _transforms(*_fk(skel, q, body_scales)[:2])


def _local_offsets(offsets, scales):
    """Marker offsets in their bodies' frames under the bodies' scales."""
    return offsets * scales


def _as_index(bodies, device) -> torch.Tensor:
    if isinstance(bodies, torch.Tensor):
        return bodies.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(bodies), dtype=torch.long, device=device)


def marker_world_positions(skel: Skeleton, q: torch.Tensor, marker_bodies,
                           marker_offsets: torch.Tensor,
                           body_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """World positions (M, 3) of M markers at one pose; the offsets (M, 3)
    scale with their body. The one-frame case of
    marker_world_positions_frames."""
    return marker_world_positions_frames(skel, q[:, None], marker_bodies, marker_offsets,
                                         body_scales)[..., 0]


def marker_table(skel: Skeleton, names: Optional[Sequence[str]] = None):
    """Static (names, bodies (M,), offsets (M, 3), fixed (M,)) of the
    skeleton's registered markers."""
    if names is None:
        names = list(skel.markers.keys())
    bodies = np.array([skel.markers[n][0] for n in names], dtype=np.int32)
    offsets = np.stack([skel.markers[n][1] for n in names])
    fixed = np.array([skel.markers[n][2] for n in names], dtype=bool)
    return names, bodies, offsets, fixed


def scaled_forward_kinematics_frames(skel: Skeleton, q: torch.Tensor,
                                     body_scales: Optional[torch.Tensor] = None):
    """World rotations (nb, 3, 3, T), positions (nb, 3, T) and the world
    screw axes W (6, nv, T) of T poses q (nv, T), by batched fk; scales
    (nb, 3) shared by the frames."""
    from nimblephysics_tpu_torch.batched.articulated import fk

    scales = None if body_scales is None else body_scales[..., None]
    R_wb, p_wb, W, _, _ = fk(_plan(skel).fw, q, scales)
    return torch.stack(R_wb), torch.stack(p_wb), W


def _marker_points(R, p, idx, marker_offsets, body_scales):
    """(M, 3, T) world points of the markers."""
    local = (marker_offsets if body_scales is None
             else _local_offsets(marker_offsets, body_scales[idx]))
    return torch.einsum("mijt,mj->mit", R[idx], local) + p[idx]


def marker_world_positions_frames(skel: Skeleton, q: torch.Tensor, marker_bodies,
                                  marker_offsets: torch.Tensor,
                                  body_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """World positions (M, 3, T) of M markers at T poses q (nv, T)."""
    R, p, _ = scaled_forward_kinematics_frames(skel, q, body_scales)
    return _marker_points(R, p, _as_index(marker_bodies, q.device), marker_offsets,
                          body_scales)


def scale_coefficients(skel: Skeleton) -> np.ndarray:
    """The static table D (nb, nb, 3) of how a body scale moves the bodies:
    a point fixed to body k moves by R_wb[b] diag(D[k, b]) ds_b under a
    change ds_b of body b's scale. D[k, b] is the translation of T_pj of
    b's child on the path to k (scaled by b's scale, in b's frame) less
    that of b's own T_cj when k is b or below it."""
    nb = skel.num_bodies
    parents = [j.parent for j in skel.joints]

    def path(k):  # k and its ancestors
        out = []
        while k >= 0:
            out.append(k)
            k = parents[k]
        return out

    D = np.zeros((nb, nb, 3))
    for k in range(nb):
        chain = path(k)
        for b in chain:
            D[k, b] -= skel.joints[b].T_cj[:3, 3]
            if parents[b] >= 0:
                D[k, parents[b]] += skel.joints[b].T_pj[:3, 3]
    return D


def marker_jacobians(skel: Skeleton, q: torch.Tensor, marker_bodies,
                     marker_offsets: torch.Tensor, body_scales: torch.Tensor,
                     coefficients: Optional[torch.Tensor] = None,
                     wrt: Sequence[str] = ("q", "scales", "offsets")):
    """Marker positions at T poses and their derivatives, in closed form
    from fk's world screw axes (no autograd). Returns pos (M, 3, T) and,
    in the order of `wrt`:

      "q": J_q (M, 3, nv, T), dpos/dq: w_d x pos + v_d for each dof d
        that moves the marker's body, (w_d; v_d) the dof's screw axis
        about the world origin;
      "scales": J_s (M, 3, nb, 3, T), dpos/d(body scales): R_wb[b][:, a]
        times D[k, b, a] + [k == b] offset[a] (scale_coefficients);
      "offsets": J_o (M, 3, 3, T), dpos/d(the marker's own offset):
        R_wb[k] diag(s_k).

    body_scales (nb, 3) shared by the frames; coefficients: the table of
    scale_coefficients as a tensor, if cached."""
    R, p, W = scaled_forward_kinematics_frames(skel, q, body_scales)
    dev, dt = q.device, q.dtype
    idx = _as_index(marker_bodies, dev)
    pos = _marker_points(R, p, idx, marker_offsets, body_scales)
    out = [pos]
    for what in wrt:
        if what == "q":
            anc = _plan(skel).consts(dt, dev).anc[idx, 0]  # (M, nv)
            ang, lin = W[:3], W[3:]  # (3, nv, T)
            cross = torch.linalg.cross(
                ang[None].expand(len(idx), -1, -1, -1),
                pos[:, :, None, :].expand(-1, -1, ang.shape[1], -1), dim=1)
            out.append((cross + lin[None]) * anc[:, None, :, None])
        elif what == "scales":
            if coefficients is None:
                coefficients = torch.as_tensor(scale_coefficients(skel), dtype=dt, device=dev)
            own = torch.nn.functional.one_hot(idx, skel.num_bodies).to(dt)
            C = coefficients[idx] + own[:, :, None] * marker_offsets[:, None, :]  # (M, nb, 3)
            out.append(torch.einsum("bijt,mbj->mibjt", R, C))
        elif what == "offsets":
            out.append(R[idx] * body_scales[idx][:, None, :, None])
        else:
            raise ValueError(f"no Jacobian with respect to {what!r}")
    return tuple(out)

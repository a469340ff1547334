"""Batched articulated-body kinematics and dynamics over a flattened world.

Counterpart of nimblephysics_tpu/batched/articulated.py for the joint
types with a constant motion subspace S on the main path: revolute,
prismatic and weld. Same trailing-batch layout: q, v (nv, B); body
rotations (3, 3, B); W (6, nv, B).

The structural identity is the reference's: the world-frame Jacobian
column of dof d is Ad(T_w,joint(d)) S_d, the same for every body that
has d as an ancestor, so one W plus a static (nb, nv) ancestor mask
replaces all per-body Jacobians. Work that is independent across joints
(relative transforms, Jacobian columns, the composite inertias and the
mass-matrix blocks) runs as one batched op over all joints; only the
tree recursions (world transforms, RNEA) walk the bodies in order.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.batched import linalg as bl
from nimblephysics_tpu_torch.dynamics import joints as J
from nimblephysics_tpu_torch.simulation.world import World

SUPPORTED_TYPES = (J.REVOLUTE, J.PRISMATIC, J.WELD)


def _skew_np(a):
    return np.array(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]],
        dtype=np.float64,
    )


def _spatial_inertia_np(mass, com, inertia):
    """Static 6x6 spatial inertia, [angular; linear] ordering."""
    c = _skew_np(np.asarray(com, dtype=np.float64))
    m = float(mass)
    G = np.zeros((6, 6))
    G[:3, :3] = np.asarray(inertia, dtype=np.float64) + m * (c @ c.T)
    G[:3, 3:] = m * c
    G[3:, :3] = m * c.T
    G[3:, 3:] = m * np.eye(3)
    return G


def _Ad_np(T):
    R, p = T[:3, :3], T[:3, 3]
    out = np.zeros((6, 6))
    out[:3, :3] = R
    out[3:, 3:] = R
    out[3:, :3] = _skew_np(p) @ R
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class _JointPlan:
    """Static per-joint data for the flattened world."""

    spec: J.JointSpec
    parent: int  # global parent body index, -1 = world
    q_index: int  # global dof offset
    num_dofs: int
    R_pj: np.ndarray
    p_pj: np.ndarray
    R_ci: np.ndarray  # T_cj^-1 rotation
    p_ci: np.ndarray
    S_const: Optional[np.ndarray]  # (6, nd) = Ad(T_cj) S_joint


class FlatWorld:
    """Static flattened plan of a World for the batched engine."""

    def __init__(self, world: World):
        self.world = world
        self.joints: List[_JointPlan] = []
        self.G_body: List[np.ndarray] = []
        body_off = world.body_offsets()
        dof_off = [s for s, _ in world.dof_slices()]
        for si, skel in enumerate(world.skeletons):
            for j in skel.joints:
                if j.joint_type not in SUPPORTED_TYPES:
                    raise NotImplementedError(
                        f"batched engine: joint type {j.joint_type!r} comes "
                        "with the rest of the batched engine (ROADMAP queue 1 "
                        "item 9)"
                    )
                T_ci = np.linalg.inv(j.T_cj)
                S_const = None
                if j.num_dofs:
                    S_local = np.zeros((6, 1))
                    if j.joint_type == J.REVOLUTE:
                        S_local[:3, 0] = j.axes[0]
                    else:
                        S_local[3:, 0] = j.axes[0]
                    S_const = _Ad_np(j.T_cj) @ S_local
                self.joints.append(
                    _JointPlan(
                        spec=j,
                        parent=body_off[si] + j.parent if j.parent >= 0 else -1,
                        q_index=dof_off[si] + j.q_index,
                        num_dofs=j.num_dofs,
                        R_pj=j.T_pj[:3, :3].copy(),
                        p_pj=j.T_pj[:3, 3].copy(),
                        R_ci=T_ci[:3, :3].copy(),
                        p_ci=T_ci[:3, 3].copy(),
                        S_const=S_const,
                    )
                )
            for b in skel.bodies:
                self.G_body.append(
                    _spatial_inertia_np(b.mass, b.com, b.inertia)
                )
        self.nb = len(self.joints)
        self.nv = world.num_dofs

        # anc[b, d] = 1 iff dof d moves body b.
        self.anc = np.zeros((self.nb, self.nv))
        for bi in range(self.nb):
            k = bi
            while k >= 0:
                jk = self.joints[k]
                self.anc[bi, jk.q_index : jk.q_index + jk.num_dofs] = 1.0
                k = jk.parent
        # Every supported moving joint has one dof: dof d <-> its body.
        self.body_of_dof = np.zeros(self.nv, dtype=np.int64)
        for bi, jp in enumerate(self.joints):
            if jp.num_dofs:
                self.body_of_dof[jp.q_index] = bi
        self._tensors: Dict[Tuple[torch.dtype, torch.device], SimpleNamespace] = {}

    def tensors(self, dtype: torch.dtype, device) -> SimpleNamespace:
        """The plan's constants as tensors, built once per dtype/device so
        that a step copies nothing from the host."""
        key = (dtype, torch.device(device))
        if key not in self._tensors:
            self._tensors[key] = self._build_tensors(dtype, key[1])
        return self._tensors[key]

    def _build_tensors(self, dtype, device) -> SimpleNamespace:
        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        nb, nv = self.nb, self.nv
        K = np.zeros((nb, 3, 3))
        axis_p = np.zeros((nb, 3))
        # Index into q padded with one zero row (index nv).
        rev_dof = np.full(nb, nv, dtype=np.int64)
        pri_dof = np.full(nb, nv, dtype=np.int64)
        for bi, jp in enumerate(self.joints):
            if jp.spec.joint_type == J.REVOLUTE:
                K[bi] = _skew_np(jp.spec.axes[0])
                rev_dof[bi] = jp.q_index
            elif jp.spec.joint_type == J.PRISMATIC:
                axis_p[bi] = jp.spec.axes[0]
                pri_dof[bi] = jp.q_index
        S_dof = np.zeros((nv, 6))
        for jp in self.joints:
            if jp.num_dofs:
                S_dof[jp.q_index] = jp.S_const[:, 0]
        # desc[p, c] = 1 iff body c is p or one of p's descendants.
        desc = np.zeros((nb, nb))
        for c in range(nb):
            k = c
            while k >= 0:
                desc[k, c] = 1.0
                k = self.joints[k].parent
        mask = self.anc[self.body_of_dof].T > 0  # (nv, nv): a moves body(d)
        return SimpleNamespace(
            R_pj=t(np.stack([jp.R_pj for jp in self.joints]))[..., None],
            p_pj=t(np.stack([jp.p_pj for jp in self.joints]))[..., None],
            R_ci=t(np.stack([jp.R_ci for jp in self.joints]))[..., None],
            p_ci=t(np.stack([jp.p_ci for jp in self.joints]))[..., None],
            K=t(K)[..., None],
            K2=t(K @ K)[..., None],
            eye3=t(np.eye(3))[..., None],
            axis_p=t(axis_p)[..., None],
            rev_dof=torch.as_tensor(rev_dof, device=device),
            pri_dof=torch.as_tensor(pri_dof, device=device),
            S_dof=t(S_dof)[..., None],  # (nv, 6, 1)
            S=[None if jp.S_const is None else t(jp.S_const)[..., None]
               for jp in self.joints],  # per joint (6, nd, 1)
            G=t(np.stack(self.G_body))[..., None],  # (nb, 6, 6, 1)
            # Gravity enters RNEA as a fictitious base acceleration.
            base_acc=t(np.concatenate([np.zeros(3), -self.world.gravity]))[:, None],
            desc=t(desc),
            body_of_dof=torch.as_tensor(self.body_of_dof, device=device),
            mass_mask=torch.as_tensor(mask, device=device),
        )


def _rel_transforms(c, q):
    """T_pj Q(q) T_cj^-1 for every joint at once: (nb, 3, 3, B), (nb, 3, B).

    Q is the Rodrigues rotation about a static axis for revolute joints
    (I + sin(t) K + (1 - cos(t)) K^2, with K = 0 elsewhere) and a
    translation along a static axis for prismatic ones.
    """
    q_pad = torch.cat([q, q.new_zeros(1, q.shape[-1])], dim=0)
    theta = q_pad[c.rev_dof][:, None, None, :]  # (nb, 1, 1, B)
    Rq = c.eye3 + c.K * torch.sin(theta) + c.K2 * (1.0 - torch.cos(theta))
    pq = c.axis_p * q_pad[c.pri_dof][:, None, :]  # (nb, 3, B)
    R1 = torch.einsum("nijb,njkb->nikb", Rq, c.R_ci)
    p1 = torch.einsum("nijb,njb->nib", Rq, c.p_ci) + pq
    R = torch.einsum("nijb,njkb->nikb", c.R_pj, R1)
    p = torch.einsum("nijb,njb->nib", c.R_pj, p1) + c.p_pj
    return R, p


def fk(fw: FlatWorld, q):
    """FK + world Jacobian columns.

    Returns (R_wb list[(3,3,B)], p_wb list[(3,B)], W (6, nv, B), S_list
    (child-frame relative Jacobians, (6, nd, 1) or None), rels
    list[(R, p)]) as the JAX package's fk does.
    """
    c = fw.tensors(q.dtype, q.device)
    Rr, pr = _rel_transforms(c, q)
    R_wb: List = []
    p_wb: List = []
    for bi, jp in enumerate(fw.joints):
        if jp.parent < 0:
            R_wb.append(Rr[bi])
            p_wb.append(pr[bi])
        else:
            Rp, pp = R_wb[jp.parent], p_wb[jp.parent]
            R_wb.append(bl.mm(Rp, Rr[bi]))
            p_wb.append(bl.mv(Rp, pr[bi]) + pp)
    rels = [(Rr[bi], pr[bi]) for bi in range(fw.nb)]
    if fw.nv:
        bod = fw.body_of_dof
        Rd = torch.stack([R_wb[b] for b in bod])  # (nv, 3, 3, B)
        pd = torch.stack([p_wb[b] for b in bod])  # (nv, 3, B)
        S = c.S_dof
        ang = torch.einsum("dijb,djb->dib", Rd, S[:, :3])
        lin = torch.cross(pd, ang, dim=1) + torch.einsum(
            "dijb,djb->dib", Rd, S[:, 3:]
        )
        W = torch.cat([ang, lin], dim=1).permute(1, 0, 2)  # (6, nv, B)
    else:
        W = q.new_zeros(6, 0, q.shape[-1])
    return R_wb, p_wb, W, c.S, rels


def _adinv_twist(R, p, V):
    """Ad(T^-1) V for T = (R, p), V (6, B): [R^T w; R^T (v - p x w)]."""
    w, v = V[:3], V[3:]
    return torch.cat([bl.mtv(R, w), bl.mtv(R, v - bl.cross(p, w))])


def _dad_transmit(R, p, F):
    """Ad(T^-1)^T F = [R m + p x (R f); R f] for F = [m; f]."""
    m, f = F[:3], F[3:]
    Rf = bl.mv(R, f)
    return torch.cat([bl.mv(R, m) + bl.cross(p, Rf), Rf])


def bias_forces(fw: FlatWorld, q, v, rels, S_list):
    """C(q, v) including the world's gravity by batched RNEA at zero
    acceleration.

    For constant-S joints the S-dot term is zero. Body-frame spatial
    recursion as in dynamics/skeleton.bias_forces of the JAX package.
    """
    c = fw.tensors(q.dtype, q.device)
    B = q.shape[-1]
    V: List = [None] * fw.nb
    A: List = [None] * fw.nb
    for bi, jp in enumerate(fw.joints):
        Rr, pr = rels[bi]
        if jp.parent < 0:
            Vp = q.new_zeros(6, B)
            Ap = c.base_acc.expand(6, B)
        else:
            Vp, Ap = V[jp.parent], A[jp.parent]
        Vi = _adinv_twist(Rr, pr, Vp)
        Ai = _adinv_twist(Rr, pr, Ap)
        if jp.num_dofs:
            dqj = v[jp.q_index : jp.q_index + jp.num_dofs]
            sj = bl.mv(S_list[bi], dqj)
            Vi = Vi + sj
            Ai = Ai + bl.ad_apply(Vi, sj)
        V[bi], A[bi] = Vi, Ai
    F: List = [None] * fw.nb
    tau = q.new_zeros(fw.nv, B)
    for bi in reversed(range(fw.nb)):
        jp = fw.joints[bi]
        Gb = c.G[bi]
        Fi = bl.mv(Gb, A[bi]) - bl.dad_apply(V[bi], bl.mv(Gb, V[bi]))
        if F[bi] is not None:
            Fi = Fi + F[bi]
        if jp.parent >= 0:
            Rr, pr = rels[bi]
            contrib = _dad_transmit(Rr, pr, Fi)
            F[jp.parent] = (
                contrib if F[jp.parent] is None else F[jp.parent] + contrib
            )
        if jp.num_dofs:
            tau[jp.q_index : jp.q_index + jp.num_dofs] = bl.mtv(S_list[bi], Fi)
    return tau


def mass_matrix_blocks(fw: FlatWorld, R_wb, p_wb, W):
    """Per-skeleton diagonal blocks of the CRBA mass matrix, aligned with
    fw.world.dof_slices() ((nd, nd, B) each; (0, 0, B) for a static one).

    M[a, d] = W_a^T Gc_body(d) W_d when dof a moves body(d), mirrored
    below the diagonal; Gc is the world-frame composite inertia. The
    reference's per-block loop computes the same entries.
    """
    c = fw.tensors(W.dtype, W.device)
    B = W.shape[-1]
    R = torch.stack(R_wb)  # (nb, 3, 3, B)
    p = torch.stack(p_wb)  # (nb, 3, B)
    Rt = R.transpose(1, 2)
    # X = Ad(T_wb^-1) = [[R^T, 0], [-R^T [p]x, R^T]].
    px = bl.skew(p.transpose(0, 1)).permute(2, 0, 1, 3)  # (nb, 3, 3, B)
    mRtP = -torch.einsum("nijb,njkb->nikb", Rt, px)
    X = torch.cat(
        [torch.cat([Rt, torch.zeros_like(Rt)], dim=2),
         torch.cat([mRtP, Rt], dim=2)],
        dim=1,
    )  # (nb, 6, 6, B)
    GX = torch.einsum("nijb,njkb->nikb", c.G, X)
    Gc = torch.einsum("njib,njkb->nikb", X, GX)
    Gcomp = torch.einsum("pc,cijb->pijb", c.desc, Gc)
    Y = torch.einsum("dijb,jdb->idb", Gcomp[c.body_of_dof], W)  # (6, nv, B)
    M0 = torch.einsum("iab,idb->adb", W, Y)  # (nv, nv, B)
    mask = c.mass_mask[:, :, None]
    zero = torch.zeros((), dtype=W.dtype, device=W.device)
    M = torch.where(
        mask, M0, torch.where(mask.transpose(0, 1), M0.transpose(0, 1), zero)
    )
    out: List = []
    for s, e in fw.world.dof_slices():
        if e == s:
            out.append(W.new_zeros(0, 0, B))
        else:
            out.append(M[s:e, s:e])
    return out


def integrate_positions(fw: FlatWorld, q, v, dt):
    """Explicit position integration; every supported type is Euclidean."""
    return q + v * dt

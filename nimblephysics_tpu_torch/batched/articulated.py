"""Batched articulated-body kinematics and dynamics over a flattened world.

Counterpart of nimblephysics_tpu/batched/articulated.py for every joint
type of its batched engine but the spline-driven ones:
  * revolute, prismatic, screw, translational, translational2d and weld,
    whose motion subspace S is constant;
  * universal, planar, euler and euler_free ("chain" joints): Q(q) is a
    product of Rodrigues rotations about static axes with a translation
    along static vectors, and S(q) and its rate are written in closed form;
  * ball and free: rotation coordinates w with R = exp(w), S through the
    right Jacobian of SO(3), exp-map position updates.
Same trailing-batch layout: q, v (nv, B); body rotations (3, 3, B); W
(6, nv, B).

The structural identity is the reference's: the world-frame Jacobian
column of dof d is Ad(T_w,joint(d)) S_d, the same for every body that
has d as an ancestor, so one W plus a static (nb, nv) ancestor mask
replaces all per-body Jacobians. Work that is independent across joints
(relative transforms, Jacobian columns, the composite inertias and the
mass-matrix blocks) runs as one batched op over all joints; only the
tree recursions (world transforms, RNEA) walk the bodies in order. The
q-dependent parts of the chain joints, and of the ball and free joints,
run as one batched op over all joints of their family.
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

_CONST_S_TYPES = (J.REVOLUTE, J.PRISMATIC, J.SCREW, J.TRANSLATIONAL,
                  J.TRANSLATIONAL_2D, J.WELD)
# Joint types whose rotation is exp(w) of their first three coordinates.
_EXP_TYPES = (J.BALL, J.FREE)
# Joint types whose S depends on q through their rotation factors.
_CHAIN_TYPES = (J.UNIVERSAL, J.PLANAR, J.EULER, J.EULER_FREE)
SUPPORTED_TYPES = _CONST_S_TYPES + _EXP_TYPES + _CHAIN_TYPES
_AXIS_VEC = {"x": np.eye(3)[0], "y": np.eye(3)[1], "z": np.eye(3)[2]}


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


def _factors(spec: J.JointSpec):
    """Q(q) of a constant-S or chain joint as rotation factors [(axis,
    local dof)], composed left to right, and translation terms [(vector,
    local dof)], summed: R = prod_s exp([a_s] q_s), p = sum_t v_t q_t
    (dynamics/joints.joint_transform of the JAX package, per type)."""
    t, ax, e = spec.joint_type, spec.axes, np.eye(3)
    if t == J.REVOLUTE:
        return [(ax[0], 0)], []
    if t == J.PRISMATIC:
        return [], [(ax[0], 0)]
    if t == J.SCREW:
        return [(ax[0], 0)], [(ax[0] * spec.screw_pitch, 0)]
    if t == J.TRANSLATIONAL:
        return [], [(e[i], i) for i in range(3)]
    if t == J.TRANSLATIONAL_2D:
        return [], [(ax[0], 0), (ax[1], 1)]
    if t == J.UNIVERSAL:
        return [(ax[0], 0), (ax[1], 1)], []
    if t == J.PLANAR:
        return [(np.cross(ax[0], ax[1]), 2)], [(ax[0], 0), (ax[1], 1)]
    if t in (J.EULER, J.EULER_FREE):
        rot = [(_AXIS_VEC[a], i) for i, a in enumerate(spec.euler_order.lower())]
        return rot, [] if t == J.EULER else [(e[i], 3 + i) for i in range(3)]
    return [], []  # weld; ball and free rotate by exp(w)


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
    Ad_cj: np.ndarray  # (6, 6) Ad(T_cj)
    S_const: Optional[np.ndarray]  # (6, nd) = Ad(T_cj) S_joint, None if S(q)
    rot: tuple = ()  # rotation factors (axis, local dof), see _factors
    trans: tuple = ()  # translation terms (vector, local dof)


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
                        f"batched engine: joint type {j.joint_type!r} (S from a "
                        "jvp of a spline-driven Q) comes with the single-world "
                        "reference path (ROADMAP queue 1 item 10)"
                    )
                T_ci = np.linalg.inv(j.T_cj)
                rot, trans = _factors(j)
                S_const = None
                if j.num_dofs and j.joint_type in _CONST_S_TYPES:
                    S_local = np.zeros((6, j.num_dofs))
                    for a, d in rot:
                        S_local[:3, d] += a
                    for a, d in trans:
                        S_local[3:, d] += a
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
                        Ad_cj=_Ad_np(j.T_cj),
                        S_const=S_const,
                        rot=tuple(rot),
                        trans=tuple(trans),
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
        # The body each dof's joint carries.
        self.body_of_dof = np.zeros(self.nv, dtype=np.int64)
        for bi, jp in enumerate(self.joints):
            self.body_of_dof[jp.q_index : jp.q_index + jp.num_dofs] = bi
        # Ball and free joints, and chain joints, in body order.
        self.exp_joints = [bi for bi, jp in enumerate(self.joints)
                           if jp.spec.joint_type in _EXP_TYPES]
        self.chain_joints = [bi for bi, jp in enumerate(self.joints)
                             if jp.spec.joint_type in _CHAIN_TYPES]
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

        def idx(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)

        nb, nv = self.nb, self.nv
        # Rotation factors and translation terms, padded to the most any
        # joint has (a zero axis is the identity; index nv reads the zero
        # row of a padded q).
        NR = max([1] + [len(jp.rot) for jp in self.joints])
        NT = max([1] + [len(jp.trans) for jp in self.joints])
        axis_r = np.zeros((NR, nb, 3))
        rot_dof = np.full((NR, nb), nv, dtype=np.int64)
        vec_t = np.zeros((NT, nb, 3))
        trans_dof = np.full((NT, nb), nv, dtype=np.int64)
        for bi, jp in enumerate(self.joints):
            for s, (a, d) in enumerate(jp.rot):
                axis_r[s, bi], rot_dof[s, bi] = a, jp.q_index + d
            for s, (a, d) in enumerate(jp.trans):
                vec_t[s, bi], trans_dof[s, bi] = a, jp.q_index + d
        K = np.stack([np.stack([_skew_np(a) for a in ar]) for ar in axis_r])
        S_dof = np.zeros((nv, 6))
        for jp in self.joints:
            if jp.S_const is not None:
                S_dof[jp.q_index : jp.q_index + jp.num_dofs] = jp.S_const.T
        # desc[p, c] = 1 iff body c is p or one of p's descendants.
        desc = np.zeros((nb, nb))
        for c in range(nb):
            k = c
            while k >= 0:
                desc[k, c] = 1.0
                k = self.joints[k].parent
        mask = self.anc[self.body_of_dof].T > 0  # (nv, nv): a moves body(d)
        ex = [self.joints[bi] for bi in self.exp_joints]
        free = [jp.spec.joint_type == J.FREE for jp in ex]
        # Joint k's column col of its 6x6 [[Jr, 0], [0, exp(-w)]] is row
        # 6k + col of the joints' stacked columns; a ball joint keeps 3.
        exp_cols = [6 * k + col for k, jp in enumerate(ex)
                    for col in range(jp.num_dofs)]
        exp_dofs = [jp.q_index + col for jp in ex for col in range(jp.num_dofs)]
        # Chain joints: slot s < NR is rotation factor s, slot NR + t is
        # translation term t; row k (NR + NT) + slot of their stacked
        # columns goes to the slot's dof.
        ch = self.chain_joints
        ch_cols, ch_dofs = [], []
        for k, bi in enumerate(ch):
            jp = self.joints[bi]
            for s, (_, d) in enumerate(jp.rot):
                ch_cols.append(k * (NR + NT) + s)
                ch_dofs.append(jp.q_index + d)
            for s, (_, d) in enumerate(jp.trans):
                ch_cols.append(k * (NR + NT) + NR + s)
                ch_dofs.append(jp.q_index + d)
        return SimpleNamespace(
            R_pj=t(np.stack([jp.R_pj for jp in self.joints]))[..., None],
            p_pj=t(np.stack([jp.p_pj for jp in self.joints]))[..., None],
            R_ci=t(np.stack([jp.R_ci for jp in self.joints]))[..., None],
            p_ci=t(np.stack([jp.p_ci for jp in self.joints]))[..., None],
            K=t(K)[..., None],  # (NR, nb, 3, 3, 1)
            K2=t(K @ K)[..., None],
            eye3=t(np.eye(3))[..., None],
            rot_dof=idx(rot_dof),  # (NR, nb)
            vec_t=t(vec_t)[..., None],  # (NT, nb, 3, 1)
            trans_dof=idx(trans_dof),  # (NT, nb)
            S_dof=t(S_dof)[..., None],  # (nv, 6, 1)
            S=[None if jp.S_const is None else t(jp.S_const)[..., None]
               for jp in self.joints],  # per joint (6, nd, 1)
            G=t(np.stack(self.G_body))[..., None],  # (nb, 6, 6, 1)
            # Gravity enters RNEA as a fictitious base acceleration.
            base_acc=t(np.concatenate([np.zeros(3), -self.world.gravity]))[:, None],
            desc=t(desc),
            body_of_dof=idx(self.body_of_dof),
            mass_mask=torch.as_tensor(mask, device=device),
            # Ball and free joints: body indices, the q rows of their
            # rotation (k, 3) and translation (k, 3; the zero row nv of a
            # padded q for a ball joint), Ad(T_cj) (k, 6, 6, 1) and where
            # their S columns go.
            exp_bodies=idx(self.exp_joints),
            exp_rot=idx([[jp.q_index + i for i in range(3)] for jp in ex]).reshape(-1, 3),
            exp_trans=idx([[jp.q_index + 3 + i if f else nv for i in range(3)]
                           for jp, f in zip(ex, free)]).reshape(-1, 3),
            exp_Ad=t(np.stack([jp.Ad_cj for jp in ex]) if ex
                     else np.zeros((0, 6, 6)))[..., None],
            exp_cols=idx(exp_cols),
            exp_dofs=idx(exp_dofs),
            # Chain joints: body indices, their factors' axes (NR, k, 3, 1),
            # vectors (NT, k, 3, 1) and dofs, Ad(T_cj) and where their S
            # columns go.
            ch_bodies=idx(ch),
            ch_axis=t(axis_r[:, ch])[..., None],
            ch_vec=t(vec_t[:, ch])[..., None],
            ch_rot_dof=idx(rot_dof[:, ch]),
            ch_trans_dof=idx(trans_dof[:, ch]),
            ch_Ad=t(np.stack([self.joints[bi].Ad_cj for bi in ch]) if ch
                    else np.zeros((0, 6, 6)))[..., None],
            ch_cols=idx(ch_cols),
            ch_dofs=idx(ch_dofs),
        )


def _flat(x):
    """(k, 3, B) -> (3, k B): the joints' batch flattened into B."""
    return x.permute(1, 0, 2).reshape(3, -1)


def _unflat(x, k):
    """(..., k B) -> (k, ..., B)."""
    return x.reshape(*x.shape[:-1], k, -1).movedim(-2, 0)


def _pad(x):
    """x (n, B) with a zero row n appended (the index of absent entries)."""
    return torch.cat([x, x.new_zeros(1, x.shape[-1])], dim=0)


def _exp_S(c, q):
    """Ad(T_cj) [[Jr(w), 0], [0, exp(-w)]] of every ball and free joint,
    (k, 6, 6, B); a ball joint's S is its first three columns."""
    k = len(c.exp_bodies)
    w = _flat(q[c.exp_rot])
    Jr = bl.so3_right_jacobian_b(w)
    z = torch.zeros_like(Jr)
    Sj = torch.cat([torch.cat([Jr, z], dim=1),
                    torch.cat([z, bl.exp_so3(-w)], dim=1)], dim=0)
    return torch.einsum("kijb,kjlb->kilb", c.exp_Ad, _unflat(Sj, k))


def _exp_S_dot_dq(c, q, v):
    """(d/dt S(q)) dq of every ball and free joint along dq = v, (k, 6, B):
    the JAX package's jvp of q -> S(q) dq, in closed form.

    With K = [w]x, t = |w|, s = w . dw and the coefficients of
    linalg._so3_coeffs, d/de Jr(w + e dw) dw = -(b'/t) s (w x dw)
    + (c'/t) s w x (w x dw) + c dw x (w x dw), and for a free joint's
    translation rate dp, d/de exp(-(w + e dw)) dp = -(a'/t) s (w x dp)
    - a (dw x dp) + (b'/t) s w x (w x dp) + b (dw x (w x dp) + w x (dw x dp)).
    """
    k = len(c.exp_bodies)
    w, d = _flat(q[c.exp_rot]), _flat(v[c.exp_rot])
    x = _flat(_pad(v)[c.exp_trans])  # zero for a ball joint
    a, b, cc, da, db, dc = bl.so3_coeff_rates(w)
    s = bl.dot(w, d)
    wd = bl.cross(w, d)
    top = -db * s * wd + dc * s * bl.cross(w, wd) + cc * bl.cross(d, wd)
    wx, dx = bl.cross(w, x), bl.cross(d, x)
    bot = (-da * s * wx - a * dx + db * s * bl.cross(w, wx)
           + b * (bl.cross(d, wx) + bl.cross(w, dx)))
    sd = _unflat(torch.cat([top, bot]), k)  # (k, 6, B)
    return torch.einsum("kijb,kjb->kib", c.exp_Ad, sd)


def _joint_Q(c, q):
    """Q(q) of every joint: (nb, 3, 3, B), (nb, 3, B), and its rotation
    factors [(nb, 3, 3, B)] (see _factors): each a Rodrigues rotation
    I + sin(t) K + (1 - cos(t)) K^2 about a static axis (K = 0 where a
    joint has fewer factors), the translation a sum of static vectors
    times coordinates; ball and free joints take (exp(w), 0) or
    (exp(w), p) with q = (w[, p])."""
    q_pad = _pad(q)
    Rs = []
    for K, K2, dof in zip(c.K, c.K2, c.rot_dof):
        theta = q_pad[dof][:, None, None, :]  # (nb, 1, 1, B)
        Rs.append(c.eye3 + K * torch.sin(theta) + K2 * (1.0 - torch.cos(theta)))
    Rq = Rs[0]
    for R in Rs[1:]:
        Rq = torch.einsum("nijb,njkb->nikb", Rq, R)
    pq = c.vec_t[0] * q_pad[c.trans_dof[0]][:, None, :]  # (nb, 3, B)
    for vec, dof in zip(c.vec_t[1:], c.trans_dof[1:]):
        pq = pq + vec * q_pad[dof][:, None, :]
    if len(c.exp_bodies):
        R_exp = _unflat(bl.exp_so3(_flat(q[c.exp_rot])), len(c.exp_bodies))
        Rq = Rq.index_copy(0, c.exp_bodies, R_exp)
        pq = pq.index_copy(0, c.exp_bodies, q_pad[c.exp_trans])
    return Rq, pq, Rs


def _rel_transforms(c, q):
    """T_pj Q(q) T_cj^-1 for every joint at once: (nb, 3, 3, B), (nb, 3, B),
    with Q(q) and its rotation factors (_joint_Q)."""
    Rq, pq, Rs = _joint_Q(c, q)
    R1 = torch.einsum("nijb,njkb->nikb", Rq, c.R_ci)
    p1 = torch.einsum("nijb,njb->nib", Rq, c.p_ci) + pq
    R = torch.einsum("nijb,njkb->nikb", c.R_pj, R1)
    p = torch.einsum("nijb,njb->nib", c.R_pj, p1) + c.p_pj
    return R, p, Rq, Rs


def _chain_cols(c, Rq, Rs):
    """The joint-frame S columns of every chain joint: for rotation factor
    s the angular column (R_{s+1} ... R_last)^T a_s (later rotations turn
    earlier axes back, as the JAX package's euler S), for translation
    term t the linear column R^T v_t with R = Q's rotation. Lists of
    (k, 3, B) over the factors and over the terms."""
    B = Rq.shape[-1]
    Rf = [R.index_select(0, c.ch_bodies) for R in Rs]
    ang = []
    for s in range(len(Rf)):
        col = c.ch_axis[s].expand(-1, -1, B)
        for R in Rf[s + 1:]:
            col = torch.einsum("kjib,kjb->kib", R, col)
        ang.append(col)
    R = Rq.index_select(0, c.ch_bodies)
    lin = [torch.einsum("kjib,kjb->kib", R, vec.expand(-1, -1, B)) for vec in c.ch_vec]
    return ang, lin


def _chain_S(c, Rq, Rs):
    """Ad(T_cj) S_joint(q) of every chain joint as (nd, 6, B) columns in
    the order of c.ch_dofs."""
    ang, lin = _chain_cols(c, Rq, Rs)
    zero = torch.zeros_like(ang[0])
    cols = torch.stack([torch.cat([a, zero], dim=1) for a in ang]
                       + [torch.cat([zero, x], dim=1) for x in lin], dim=1)
    cols = torch.einsum("kijb,ksjb->ksib", c.ch_Ad, cols)  # (k, slots, 6, B)
    return cols.reshape(-1, 6, Rq.shape[-1])[c.ch_cols]


def _chain_S_dot_dq(c, q, v):
    """(d/dt S(q)) dq of every chain joint along dq = v, (k, 6, B): the JAX
    package's jvp of q -> S(q) dq, in closed form. With the angular
    columns c_s and w_s = dq_s c_s, d/dt c_s = -(sum_{m > s} w_m) x c_s;
    with the body rate omega = sum_s w_s, d/dt (R^T v_t) = -omega x R^T v_t.
    """
    Rq, _, Rs = _joint_Q(c, q)
    ang, lin = _chain_cols(c, Rq, Rs)
    v_pad = _pad(v)
    terms = [dq[:, None, :] * col for dq, col in zip(v_pad[c.ch_rot_dof], ang)]
    ang_dot = torch.zeros_like(terms[0])
    omega = torch.zeros_like(terms[0])
    for w in reversed(terms):
        ang_dot = ang_dot - torch.cross(omega, w, dim=1)
        omega = omega + w
    ell = sum(dq[:, None, :] * x for dq, x in zip(v_pad[c.ch_trans_dof], lin))
    sd = torch.cat([ang_dot, -torch.cross(omega, ell, dim=1)], dim=1)
    return torch.einsum("kijb,kjb->kib", c.ch_Ad, sd)


def fk(fw: FlatWorld, q):
    """FK + world Jacobian columns.

    Returns (R_wb list[(3,3,B)], p_wb list[(3,B)], W (6, nv, B), S_list
    (child-frame relative Jacobians: (6, nd, 1) where S is constant,
    (6, nd, B) for chain, ball and free joints, None without dofs), rels
    list[(R, p)]) as the JAX package's fk does.
    """
    c = fw.tensors(q.dtype, q.device)
    B = q.shape[-1]
    Rr, pr, Rq, Rs = _rel_transforms(c, q)
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
    S = c.S_dof  # (nv, 6, 1)
    S_list = c.S
    q_dep = fw.exp_joints + fw.chain_joints
    if q_dep:
        S = S.expand(-1, -1, B)
        if fw.exp_joints:
            cols = _exp_S(c, q).permute(0, 2, 1, 3).reshape(-1, 6, B)
            S = S.index_copy(0, c.exp_dofs, cols[c.exp_cols])
        if fw.chain_joints:
            S = S.index_copy(0, c.ch_dofs, _chain_S(c, Rq, Rs))
        S_list = list(S_list)
        for bi in q_dep:
            jp = fw.joints[bi]
            S_list[bi] = S[jp.q_index : jp.q_index + jp.num_dofs].permute(1, 0, 2)
    if fw.nv:
        bod = fw.body_of_dof
        Rd = torch.stack([R_wb[b] for b in bod])  # (nv, 3, 3, B)
        pd = torch.stack([p_wb[b] for b in bod])  # (nv, 3, B)
        ang = torch.einsum("dijb,djb->dib", Rd, S[:, :3])
        lin = torch.cross(pd, ang, dim=1) + torch.einsum(
            "dijb,djb->dib", Rd, S[:, 3:]
        )
        W = torch.cat([ang, lin], dim=1).permute(1, 0, 2)  # (6, nv, B)
    else:
        W = q.new_zeros(6, 0, B)
    return R_wb, p_wb, W, S_list, rels


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

    The S-dot term is zero for constant-S joints, _chain_S_dot_dq for
    chain joints and _exp_S_dot_dq for ball and free ones. Body-frame spatial recursion as in
    dynamics/skeleton.bias_forces of the JAX package.
    """
    c = fw.tensors(q.dtype, q.device)
    B = q.shape[-1]
    sdot = {}
    if fw.exp_joints:
        sdot.update(zip(fw.exp_joints, _exp_S_dot_dq(c, q, v)))
    if fw.chain_joints:
        sdot.update(zip(fw.chain_joints, _chain_S_dot_dq(c, q, v)))
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
            if bi in sdot:
                Ai = Ai + sdot[bi]
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
    """Explicit position integration: q + v dt, and for ball and free
    joints the exp-map update R' = exp(w) exp(Jr(w) dw dt), w' = log(R'),
    p' = p + exp(w) exp(-w) dp dt (the JAX package's per-type rule)."""
    out = q + v * dt
    c = fw.tensors(q.dtype, q.device)
    k = len(c.exp_bodies)
    if not k:
        return out
    w, dw = _flat(q[c.exp_rot]), _flat(v[c.exp_rot])
    p, dp = _flat(_pad(q)[c.exp_trans]), _flat(_pad(v)[c.exp_trans])
    Jr = bl.so3_right_jacobian_b(w)
    Rq = bl.exp_so3(w)
    Rn = bl.mm(Rq, bl.exp_so3(bl.mv(Jr, dw) * dt))
    pn = p + bl.mv(Rq, bl.mv(bl.exp_so3(-w), dp) * dt)
    new = _unflat(torch.cat([bl.log_so3(Rn), pn]), k)  # (k, 6, B)
    return out.index_copy(0, c.exp_dofs, new.reshape(6 * k, -1)[c.exp_cols])

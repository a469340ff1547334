"""Constraint rows: contacts, joint limits, motors, ball and weld
constraints -> LcpMeta, and one world's rows.

Counterpart of ConstraintAssembler in
nimblephysics_tpu/constraint/assembly.py. Row layout: 3 rows per contact
slot [normal, tangent1, tangent2], then one row per finite position
limit [lower, upper per dof], then motor rows, then dynamic-joint rows.
`assemble_b` builds the rows of a batch of worlds (the batched engine's
layout, batch in the trailing axis); `assemble`, the JAX package's
single-world signature, runs it on a batch of one.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from nimblephysics_tpu_torch.batched import linalg as bl
from nimblephysics_tpu_torch.batched.articulated import FlatWorld, _pad
from nimblephysics_tpu_torch.collision.collider import Collider
from nimblephysics_tpu_torch.constraint.lcp import LcpMeta
from nimblephysics_tpu_torch.simulation.world import World


def tangent_basis_b(n):
    """The ODE friction basis of unit normals n (..., 3, K), each of t1,
    t2 (..., 3, K): t1 = normalize(e_z x n), or normalize(e_x x n) where
    e_z x n vanishes, and t2 = n x t1 (ContactConstraint.cpp:735)."""
    z = torch.zeros_like(n)
    z[..., 2, :] = 1.0
    x = torch.zeros_like(n)
    x[..., 0, :] = 1.0
    t_z = torch.cross(z, n, dim=-2)
    t_x = torch.cross(x, n, dim=-2)
    use_x = torch.sum(t_z * t_z, dim=-2, keepdim=True) < 1e-12
    t_raw = torch.where(use_x, t_x, t_z)
    norm2 = torch.sum(t_raw * t_raw, dim=-2, keepdim=True)
    t1 = t_raw / torch.sqrt(torch.clamp(norm2, min=1e-18))
    t2 = torch.cross(n, t1, dim=-2)
    return t1, t2


def tangent_basis(n):
    """tangent_basis_b for unit normals n (C, 3): t1, t2 (C, 3)."""
    t1, t2 = tangent_basis_b(n.T)
    return t1.T, t2.T


@dataclasses.dataclass(frozen=True, eq=False)
class _LimitRow:
    dof: int  # world dof index
    sign: float  # +1: lower limit, -1: upper limit
    limit: float


class ConstraintAssembler:
    """Static row plan for one World."""

    def __init__(self, world: World, collider: Collider):
        self.world = world
        self.collider = collider
        self.num_contacts = collider.num_contacts
        self._tensors: dict = {}

        self.limit_rows: List[_LimitRow] = []
        lo = world.position_lower_limits()
        hi = world.position_upper_limits()
        for d in range(world.num_dofs):
            if np.isfinite(lo[d]):
                self.limit_rows.append(_LimitRow(d, +1.0, float(lo[d])))
            if np.isfinite(hi[d]):
                self.limit_rows.append(_LimitRow(d, -1.0, float(hi[d])))

        # One force-limited row per servo/mimic/locked dof.
        self.motor_rows: List[dict] = []
        for d in range(world.num_dofs):
            act = world.dof_actuator(d)
            if act["kind"] in ("servo", "mimic", "locked"):
                self.motor_rows.append(dict(dof=d, **act))

        self.dyn_rows = sum(
            6 if con["kind"] == "weld" else 3
            for con in world.dynamic_constraints
        )

        C = self.num_contacts
        L = len(self.limit_rows)
        Mrows = len(self.motor_rows)
        n = 3 * C + L + Mrows + self.dyn_rows
        findex = np.full(n, -1, dtype=np.int32)
        is_friction = np.zeros(n, dtype=bool)
        for c in range(C):
            findex[3 * c + 1] = 3 * c
            findex[3 * c + 2] = 3 * c
            is_friction[3 * c + 1] = True
            is_friction[3 * c + 2] = True
        # Contacts/limits [0, inf); motor rows +-force_limit*dt; dynamic
        # joint rows are equalities.
        lo_const = np.zeros(n)
        hi_const = np.full(n, np.inf)
        dt = world.time_step
        base = 3 * C + L
        for i, mr in enumerate(self.motor_rows):
            lim = mr["force_limit"] * dt
            lo_const[base + i] = -lim
            hi_const[base + i] = lim
        lo_const[base + Mrows:] = -np.inf
        has_boxes = Mrows > 0 or self.dyn_rows > 0
        self.meta = LcpMeta(
            findex=findex,
            is_friction=is_friction,
            lo_const=lo_const if has_boxes else None,
            hi_const=hi_const if has_boxes else None,
            iterations=world.solver.lcp_iterations,
            solver=world.solver.lcp_solver,
            refine_rounds=world.solver.lcp_refine_rounds,
            seed_pgs_sweeps=world.solver.lcp_seed_pgs_sweeps,
            k_active=min(n, max(16, 2 * world.num_dofs + 8)),
        )

    @property
    def num_rows(self) -> int:
        return (
            3 * self.num_contacts
            + len(self.limit_rows)
            + len(self.motor_rows)
            + self.dyn_rows
        )

    def contact_valid(self, cdepth):
        """Contact slots whose rows are live: 0 < depth <= the clipping
        depth (bool, cdepth's shape)."""
        return (cdepth > 0.0) & (cdepth <= self.world.solver.contact_clipping_depth)

    def row_consts(self, dtype, device) -> SimpleNamespace:
        """Every static array the rows read, as tensors, built once per
        dtype and device."""
        key = (dtype, torch.device(device))
        if key not in self._tensors:
            self._tensors[key] = self._build_row_consts(dtype, torch.device(device))
        return self._tensors[key]

    def _build_row_consts(self, dtype, device) -> SimpleNamespace:
        def t(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)

        def idx(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)

        w = self.world
        nv = w.num_dofs
        fw = FlatWorld(w)
        anc = fw.anc  # (NB, nv): 1 where the dof moves the body
        # Motor rows: J (M, nv) with 1 at the dof (and -multiplier at a
        # mimic's leader); a servo's target velocity is its control, read
        # from control padded with a zero row (index nv) for the others.
        Jm = np.zeros((len(self.motor_rows), nv))
        target = np.full(len(self.motor_rows), nv, dtype=np.int64)
        for i, mr in enumerate(self.motor_rows):
            Jm[i, mr["dof"]] = 1.0
            if mr["kind"] == "mimic" and mr["mimic_dof"] is not None:
                Jm[i, mr["mimic_dof"]] = -mr["mimic_multiplier"]
            if mr["kind"] == "servo":
                target[i] = mr["dof"]
        # Ball and weld constraints: the bodies' dof masks (1, nv, 1), the
        # anchor offsets (3, 1) and a weld's relative rotation (3, 3, 1).
        dyn = [
            SimpleNamespace(
                kind=con["kind"], body_a=con["body_a"], body_b=con["body_b"],
                mask_a=t(anc[con["body_a"]])[None, :, None],
                mask_b=t(anc[con["body_b"]])[None, :, None],
                offset_a=t(con["offset_a"])[:, None],
                offset_b=t(con["offset_b"])[:, None],
                rel_rot=t(con["rel_rot"])[..., None] if con["kind"] == "weld" else None,
            )
            for con in w.dynamic_constraints
        ]
        # Each contact slot's bodies, combined friction and restitution.
        cc = self.collider._consts(dtype, device)
        slots = self.collider.slots
        per_slot = [s.n_slots for s in slots]
        body_a = np.repeat([s.body_a for s in slots], per_slot).astype(np.int64)
        body_b = np.repeat([s.body_b for s in slots], per_slot).astype(np.int64)
        # Contacts between bodies that no dof moves get dmask = 0, so
        # identically-zero rows, in the same row order.
        dmask = anc[body_a] - anc[body_b] if slots else np.zeros((0, nv))
        rows = self.limit_rows
        return SimpleNamespace(
            body_of_dof=idx(fw.body_of_dof),
            dmask=t(dmask)[:, None, :, None],  # (C, 1, nv, 1)
            restitution=cc["restitution"][:, None],
            mu=cc["friction"][:, None],
            lim_dofs=idx([r.dof for r in rows]),
            lim_signs=t([r.sign for r in rows])[:, None],
            lim_values=t([r.limit for r in rows])[:, None],
            motor_J=t(Jm)[:, :, None],  # (M, nv, 1)
            motor_target=idx(target),
            dyn=dyn,
        )

    def _contact_block(self, c, v_pre, cpoint, cnormal, cdepth, W):
        """Contact rows: J (3C, nv, B), valid/b/mu (3C, B). b is -(J v_pre)
        plus, on a contact's normal row, the restitution bounce (e times
        the approach speed above the bouncing threshold, capped) or, with
        penetration correction on, the error-reduction velocity."""
        cfg = self.world.solver
        dt = self.world.time_step
        C = self.num_contacts
        B = v_pre.shape[-1]
        t1, t2 = tangent_basis_b(cnormal)  # (C, 3, B)
        D = torch.stack([cnormal, t1, t2], dim=1)  # (C, 3 dirs, 3, B)
        # Row spatial vector about the world origin: [p x d; d].
        g = torch.cat([torch.cross(cpoint[:, None].expand_as(D), D, dim=2), D], dim=2)
        Jc = (torch.einsum("ckib,idb->ckdb", g, W) * c.dmask).reshape(3 * C, -1, B)

        b0 = -torch.sum(Jc * v_pre[None, :, :], dim=1)  # (3C, B)
        b_n = b0[0::3]
        zero = torch.zeros_like(b_n)
        rest_vel = torch.where(c.restitution > cfg.restitution_threshold,
                               b_n * c.restitution, zero)
        bounce = torch.where(rest_vel > cfg.bouncing_velocity_threshold,
                             torch.clamp(rest_vel, max=cfg.max_bouncing_velocity), zero)
        if cfg.penetration_correction_enabled:
            pen = torch.clamp((cdepth - cfg.error_allowance)
                              * cfg.error_reduction_parameter / dt,
                              0.0, cfg.max_error_reduction_velocity)
            bounce = torch.where(bounce > 0.0, bounce, pen)
        b_c = b0.reshape(C, 3, B)
        b_c = torch.cat([b_c[:, :1] + bounce[:, None], b_c[:, 1:]], 1)
        mu_eff = torch.where(c.mu > cfg.friction_threshold, c.mu,
                             torch.zeros_like(c.mu)).expand(C, B)
        mu_c = torch.stack([torch.zeros_like(mu_eff), mu_eff, mu_eff], 1)
        valid_rows = self.contact_valid(cdepth).repeat_interleave(3, dim=0)
        return Jc, valid_rows, b_c.reshape(3 * C, B), mu_c.reshape(3 * C, B)

    def _dynamic_block(self, k, v_pre, W, R_wb, p_wb):
        """The rows of one ball (3: the anchor points) or weld (6: the
        orientation, then the anchor points) constraint, with ERP feedback
        of the position error, and the rotation error log(R_a rel R_b^T)
        for a weld."""
        cfg = self.world.solver
        gamma = cfg.error_reduction_parameter / self.world.time_step
        cap = cfg.joint_max_error_reduction_velocity
        A, Bb = k.body_a, k.body_b
        pA = bl.mv(R_wb[A], k.offset_a) + p_wb[A]
        pB = bl.mv(R_wb[Bb], k.offset_b) + p_wb[Bb]
        WA, WB = W * k.mask_a, W * k.mask_b
        J = (WA[3:] - bl.cross_cols(pA, WA[:3])) - (WB[3:] - bl.cross_cols(pB, WB[:3]))
        err = pA - pB
        if k.kind == "weld":
            R_e = bl.mm(bl.mm(R_wb[A], k.rel_rot), R_wb[Bb].transpose(0, 1))
            J = torch.cat([(WA - WB)[:3], J])
            err = torch.cat([bl.log_so3(R_e), err])
        b = -torch.sum(J * v_pre[None, :, :], dim=1) - torch.clamp(gamma * err, -cap, cap)
        return J, torch.ones_like(b, dtype=torch.bool), b, torch.zeros_like(b)

    def assemble_b(self, q, v_pre, cpoint, cnormal, cdepth, W, R_wb, p_wb, control):
        """The rows of a batch of worlds, batch in the trailing axis:
        (J (n, nv, B), b, mu, valid (n, B)), with J, b and mu zeroed on
        rows that are not valid (they pin to z = 0).

        q, v_pre, control (nv, B); the contacts cpoint, cnormal (C, 3, B)
        and cdepth (C, B); W (6, nv, B): each dof's world-frame screw axis
        [angular; linear] about the world origin; R_wb (NB, 3, 3, B), p_wb
        (NB, 3, B). Limit rows push back by ERP at their violation, servo
        rows drive toward their commanded velocity (the control), ball and
        weld rows hold their anchors and relative rotation. Rows of
        contacts outside (0, clipping depth] and of inactive limits are
        not valid.
        """
        cfg = self.world.solver
        dt = self.world.time_step
        nv = self.world.num_dofs
        B = q.shape[-1]
        c = self.row_consts(q.dtype, q.device)
        blocks = []
        if self.num_contacts > 0:
            blocks.append(self._contact_block(c, v_pre, cpoint, cnormal, cdepth, W))
        L = len(self.limit_rows)
        if L > 0:
            Jl = torch.zeros(L, nv, B, dtype=q.dtype, device=q.device)
            Jl[torch.arange(L, device=q.device), c.lim_dofs] = c.lim_signs
            depth_l = c.lim_signs * (c.lim_values - q[c.lim_dofs])
            b_l = -(c.lim_signs * v_pre[c.lim_dofs]) + torch.clamp(
                depth_l * cfg.error_reduction_parameter / dt,
                0.0, cfg.joint_max_error_reduction_velocity)
            blocks.append((Jl, depth_l > -cfg.joint_limit_margin, b_l, torch.zeros_like(b_l)))
        M = c.motor_J.shape[0]
        if M > 0:
            b_m = _pad(control)[c.motor_target] - torch.sum(c.motor_J * v_pre[None], dim=1)
            blocks.append((c.motor_J.expand(M, nv, B), torch.ones_like(b_m, dtype=torch.bool),
                           b_m, torch.zeros_like(b_m)))
        for k in c.dyn:
            blocks.append(self._dynamic_block(k, v_pre, W, R_wb, p_wb))
        J, valid, b, mu = (torch.cat([blk[i] for blk in blocks], dim=0) for i in range(4))
        vf = valid.to(q.dtype)
        return J * vf[:, None, :], b * vf, mu * vf, valid

    def assemble(self, q, v_pre, contacts, J_world, T_wb=None,
                 control: Optional[torch.Tensor] = None):
        """One world's rows for the boxed LCP: (J_masked (n, nv), b (n,),
        mu (n,), valid (n,)); assemble_b on a batch of one.

        contacts: the Collider's Contacts at q; J_world (NB, 6, nv): each
        body's world-frame Jacobian [angular; linear] about the world
        origin; T_wb (NB, 4, 4): the bodies' world transforms, which ball
        and weld rows read; control (nv,): the servos' commands (zero when
        None).
        """
        if self.dyn_rows and T_wb is None:
            raise ValueError("ball and weld rows need the bodies' transforms T_wb")
        nv = self.world.num_dofs
        c = self.row_consts(q.dtype, q.device)
        # Each dof's screw axis, read from the body that its joint carries.
        W = J_world[c.body_of_dof, :, torch.arange(nv, device=q.device)].T
        R_wb = p_wb = None
        if T_wb is not None:
            R_wb, p_wb = T_wb[:, :3, :3, None], T_wb[:, :3, 3, None]
        cpoint = cnormal = cdepth = None
        if self.num_contacts > 0:
            cpoint, cnormal, cdepth = (x[..., None] for x in
                                       (contacts.point, contacts.normal, contacts.depth))
        if control is None:
            control = v_pre.new_zeros(nv)
        J, b, mu, valid = self.assemble_b(q[:, None], v_pre[:, None], cpoint, cnormal, cdepth,
                                          W[..., None], R_wb, p_wb, control[:, None])
        return J[..., 0], b[:, 0], mu[:, 0], valid[:, 0]

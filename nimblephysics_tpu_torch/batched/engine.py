"""BatchedEngine: the batched, differentiable timestep on a GPU (or the
CPU).

Counterpart of nimblephysics_tpu/batched/engine.py: smooth dynamics,
collision at the pre-step q, the boxed LCP on the pre-constraint
velocity, the impulse velocity update and parallel position integration
from the pre-step velocity. Same layout at the public functions: q, v and
control are (nv, B), impulses (n_rows, B). Gradients flow through torch
autograd and stop where the JAX package's do (batched/lcp.py);
`remat_step` is the same step with the backward recompute of
jax.checkpoint(step, policy=LCP_REMAT_POLICY).

The rows are the JAX package's: contacts, joint limits, servo, mimic and
locked motors, and the user's ball and weld constraints with their
error feedback. The LCP is solved as the JAX package's step solves it:
one boxed LCP per static constraint island when the world splits into
several (SolverConfig.contact_islands), else, under
SolverConfig.contact_cap, one on the `cap` deepest contact slots of each
world (with the rows that are not contacts), else one on every row. A
world with no rows runs no collision and no LCP: v = v_pre and the
impulses are (0, B).

Device rule: the engine runs on the card unless the caller asks for the
CPU. BatchedEngine(world) with no device means "cuda" and raises where
there is no GPU; it never carries on on the CPU quietly.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.batched import linalg as bl
from nimblephysics_tpu_torch.batched.articulated import (
    FlatWorld,
    _pad,
    bias_forces,
    fk,
    integrate_positions,
    mass_matrix_blocks,
)
from nimblephysics_tpu_torch.batched.collision import BatchedCollider
from nimblephysics_tpu_torch.batched.lcp import LcpSaved, boxed_lcp_b
from nimblephysics_tpu_torch.collision.collider import Collider
from nimblephysics_tpu_torch.constraint.assembly import ConstraintAssembler
from nimblephysics_tpu_torch.constraint.lcp import LcpMeta, subset_meta
from nimblephysics_tpu_torch.simulation.world import World


class BatchedStepResult(NamedTuple):
    q: torch.Tensor  # (nv, B)
    v: torch.Tensor  # (nv, B)
    v_pre: torch.Tensor  # (nv, B)
    impulses: torch.Tensor  # (n_rows, B)
    contact_points: torch.Tensor  # (C, 3, B)
    contact_normals: torch.Tensor  # (C, 3, B)
    contact_depths: torch.Tensor  # (C, B)


class _Recompute(torch.autograd.Function):
    """fn(*inputs) -> tuple of tensors, run without a graph; the backward
    runs it again with one and backpropagates through that (a checkpoint
    of fn). Gradients reach the explicit inputs only: fn must close over
    no tensor that needs one."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        ctx.fn = fn
        ctx.save_for_backward(*inputs)
        return tuple(fn(*inputs))

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[1:]
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outs = ctx.fn(*inputs)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x, need in zip(inputs, needs) if need]
        if not pairs:  # the cotangents reach no output that depends on an input
            return (None,) * (1 + len(needs))
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs], allow_unused=True
        ))
        return (None, *[next(got) if need else None for need in needs])


class LcpProblem(NamedTuple):
    """The LCP one step solves, and what the step needs around it."""

    F: torch.Tensor  # (n, nv, B) = J L^-T
    b: torch.Tensor  # (n, B)
    mu: torch.Tensor  # (n, B)
    v_pre: torch.Tensor  # (nv, B)
    Ls: list  # per-skeleton Cholesky factors of M
    contact_points: torch.Tensor
    contact_normals: torch.Tensor
    contact_depths: torch.Tensor


class StepSaved(NamedTuple):
    """What a step decided without gradients, for its replay: the LcpSaved
    of each LCP it solved (one per island, or one) and, under the contact
    cap, the rows it gathered."""

    lcps: Tuple[LcpSaved, ...]
    rows_idx: Optional[torch.Tensor] = None  # (3 cap, B) capped contact rows


def _tangent_basis_b(n):
    """ODE tangent basis (parity: assembly.tangent_basis): n (..., 3, K)
    unit normals -> (t1, t2), each (..., 3, K)."""
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


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "BatchedEngine runs on the GPU by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class BatchedEngine:
    """Static batched step plan for one World on one device and dtype."""

    def __init__(self, world: World, device=None, dtype=torch.float32):
        self.world = world
        self.device = _resolve_device(device)
        self.dtype = dtype
        self.fw = FlatWorld(world)
        self.collider = Collider(world)
        self.bcollider = BatchedCollider(self.collider)
        self.assembler = ConstraintAssembler(world, self.collider)
        self.meta = self.assembler.meta
        self.skel_slices = world.dof_slices()
        # Static constraint islands (None: one island, or islands off).
        self.islands = (
            self._build_islands() if world.solver.contact_islands else None
        )
        self._island_idx = [
            (torch.as_tensor(rows, device=self.device),
             torch.as_tensor(dofs, device=self.device))
            for rows, dofs, _ in self.islands or ()
        ]
        # The contact cap applies to a one-island world with more contact
        # slots than the cap, as in the JAX package.
        cap = world.solver.contact_cap
        self.contact_cap = None
        self.meta_cap = None
        if (cap is not None and self.islands is None
                and self.bcollider.num_contacts > cap):
            self.contact_cap = int(cap)
            self.meta_cap = self._build_cap_meta(self.contact_cap)
        nv = world.num_dofs

        def per_dof(getter):
            if not world.skeletons:
                return np.zeros(nv)
            return np.concatenate([getter(s) for s in world.skeletons])

        force_mask = np.ones(nv)
        for d, act in world.actuator_types.items():
            if act["kind"] != "force":
                force_mask[d] = 0.0
        self._c = self._build_consts(
            damping=per_dof(lambda s: s.damping_coeffs()),
            stiffness=per_dof(lambda s: s.spring_stiffnesses()),
            rest_pos=per_dof(lambda s: s.rest_positions()),
            force_mask=force_mask,
        )

    def _build_consts(self, **per_dof) -> SimpleNamespace:
        """Every static array the step reads, on the engine's device."""

        def t(x):
            return torch.as_tensor(
                np.asarray(x), dtype=self.dtype, device=self.device
            )

        nv = self.world.num_dofs
        anc = self.fw.anc
        # Motor rows: J (M, nv) with 1 at the dof (and -multiplier at a
        # mimic's leader); a servo's target velocity is its control, read
        # from control padded with a zero row (index nv) for the others.
        motors = self.assembler.motor_rows
        Jm = np.zeros((len(motors), nv))
        target = np.full(len(motors), nv, dtype=np.int64)
        for i, mr in enumerate(motors):
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
                rel_rot=(t(con["rel_rot"])[..., None] if con["kind"] == "weld"
                         else None),
            )
            for con in self.world.dynamic_constraints
        ]

        C = self.bcollider.num_contacts
        dmask = np.stack(
            [anc[self.bcollider.body_a[c]] - anc[self.bcollider.body_b[c]]
             for c in range(C)]
        ) if C else np.zeros((0, self.world.num_dofs))
        rows = self.assembler.limit_rows
        return SimpleNamespace(
            **{k: t(v)[:, None] for k, v in per_dof.items()},
            dmask=t(dmask)[:, None, :, None],  # (C, 1, nv, 1)
            restitution=t(self.bcollider.restitution)[:, None],
            mu=t(self.bcollider.mu)[:, None],
            lim_dofs=torch.as_tensor(
                np.array([r.dof for r in rows], dtype=np.int64),
                device=self.device,
            ),
            lim_signs=t([r.sign for r in rows])[:, None],
            lim_values=t([r.limit for r in rows])[:, None],
            action_idx=torch.as_tensor(
                np.asarray(self.world.action_indices, dtype=np.int64),
                device=self.device,
            ),
            motor_J=t(Jm)[:, :, None],  # (M, nv, 1)
            motor_target=torch.as_tensor(target, device=self.device),
            dyn=dyn,
        )

    def _build_cap_meta(self, cap: int) -> LcpMeta:
        """The row plan of the capped LCP: [3 cap contact rows][every
        non-contact row]. Every contact slot has the same plan ([normal,
        friction, friction], findex to its normal, bounds [0, inf)), so
        which slots each world gathers leaves the plan static."""
        meta = self.meta
        C3 = 3 * self.bcollider.num_contacts
        n_sel = 3 * cap + meta.n - C3
        findex = np.full(n_sel, -1, dtype=np.int32)
        findex[1 : 3 * cap : 3] = findex[2 : 3 * cap : 3] = np.arange(0, 3 * cap, 3)
        lo = hi = None
        if meta.lo_const is not None:
            lo = np.concatenate([np.zeros(3 * cap), meta.lo_const[C3:]])
            hi = np.concatenate([np.full(3 * cap, np.inf), meta.hi_const[C3:]])
        return dataclasses.replace(
            meta,
            findex=findex,
            is_friction=findex >= 0,
            lo_const=lo,
            hi_const=hi,
            k_active=min(n_sel, max(16, 2 * self.world.num_dofs + 8)),
        )

    def _build_islands(self):
        """Partition LCP rows into static constraint islands: connected
        components over dynamic skeletons of every potential constraint
        row (static skeletons never merge components). Returns None for
        one island, else [(rows, dofs, LcpMeta)] per island, in the order
        of each island's first row; rows that touch no dynamic skeleton
        ride in the first island."""
        w = self.world
        slices = self.skel_slices
        skel_of_dof = np.full(w.num_dofs, -1, dtype=np.int64)
        for si, (s, e) in enumerate(slices):
            skel_of_dof[s:e] = si
        anc = self.fw.anc

        def skel_of_body(b):
            nz = np.nonzero(anc[int(b)])[0]
            return int(skel_of_dof[nz[0]]) if nz.size else -1

        row_skels: List[Set[int]] = []
        for c in range(self.bcollider.num_contacts):
            ss = {
                skel_of_body(self.bcollider.body_a[c]),
                skel_of_body(self.bcollider.body_b[c]),
            } - {-1}
            row_skels += [ss, ss, ss]
        for r in self.assembler.limit_rows:
            row_skels.append({int(skel_of_dof[r.dof])} - {-1})
        for mr in self.assembler.motor_rows:
            ss = {int(skel_of_dof[mr["dof"]])}
            if mr.get("mimic_dof") is not None:
                ss.add(int(skel_of_dof[mr["mimic_dof"]]))
            row_skels.append(ss - {-1})
        for con in w.dynamic_constraints:
            ss = {skel_of_body(con["body_a"]), skel_of_body(con["body_b"])} - {-1}
            row_skels += [ss] * (6 if con["kind"] == "weld" else 3)

        parent = list(range(len(slices)))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for ss in row_skels:
            it = iter(ss)
            first = next(it, None)
            for other in it:
                parent[find(other)] = find(first)
        comp_rows: dict = {}
        for i, ss in enumerate(row_skels):
            key = find(next(iter(ss))) if ss else None
            comp_rows.setdefault(key, []).append(i)
        dead = comp_rows.pop(None, [])
        if len(comp_rows) < 2:
            return None
        keys = sorted(comp_rows, key=lambda k: comp_rows[k][0])
        comp_rows[keys[0]] += dead
        islands = []
        for k in keys:
            rows = np.asarray(sorted(comp_rows[k]), dtype=np.int64)
            dofs = np.concatenate([
                np.arange(s, e) for si, (s, e) in enumerate(slices)
                if find(si) == k and e > s
            ])
            islands.append((rows, dofs, subset_meta(self.meta, rows, len(dofs))))
        return islands

    @property
    def num_rows(self) -> int:
        return self.assembler.num_rows

    def _check(self, name, x, rows):
        if x.device != self.device or x.dtype != self.dtype:
            raise ValueError(
                f"{name} is {x.dtype} on {x.device}; this engine takes "
                f"{self.dtype} on {self.device}"
            )
        if x.dim() != 2 or x.shape[0] != rows:
            raise ValueError(f"{name} must be ({rows}, B), got {tuple(x.shape)}")

    def action_to_forces(self, action):
        """(na, B) action -> (nv, B) generalized forces (static scatter)."""
        self._check("action", action, self.world.action_size)
        out = action.new_zeros(self.world.num_dofs, action.shape[1])
        return out.index_copy(0, self._c.action_idx, action)

    # ------------------------------------------------------------------

    def _contact_block(self, v_pre, cpoint, cnormal, cdepth, W):
        """Contact rows: J (3C, nv, B), valid/b/mu (3C, B)."""
        cfg = self.world.solver
        dt = self.world.time_step
        C = self.bcollider.num_contacts
        B = v_pre.shape[-1]
        c = self._c
        t1, t2 = _tangent_basis_b(cnormal)  # (C, 3, B)
        D = torch.stack([cnormal, t1, t2], dim=1)  # (C, 3 dirs, 3, B)
        # Row spatial vector about the world origin: [p x d; d].
        g = torch.cat(
            [torch.cross(cpoint[:, None].expand_as(D), D, dim=2), D], dim=2
        )  # (C, 3, 6, B)
        # Contacts between bodies that no dof moves get dmask = 0, so
        # identically-zero rows, in the same row order.
        Jc = torch.einsum("ckib,idb->ckdb", g, W) * c.dmask
        Jc = Jc.reshape(3 * C, -1, B)

        valid_c = self._contact_valid(cdepth)
        b0 = -torch.sum(Jc * v_pre[None, :, :], dim=1)  # (3C, B)
        b_n = b0[0::3]
        rest = c.restitution
        rest_vel = torch.where(
            rest > cfg.restitution_threshold, b_n * rest, torch.zeros_like(b_n)
        )
        bounce = torch.where(
            rest_vel > cfg.bouncing_velocity_threshold,
            torch.clamp(rest_vel, max=cfg.max_bouncing_velocity),
            torch.zeros_like(rest_vel),
        )
        if cfg.penetration_correction_enabled:
            pen = torch.clamp(
                (cdepth - cfg.error_allowance)
                * cfg.error_reduction_parameter / dt,
                0.0,
                cfg.max_error_reduction_velocity,
            )
            bounce = torch.where(bounce > 0.0, bounce, pen)
        b_c = b0.reshape(C, 3, B)
        b_c = torch.cat([b_c[:, :1] + bounce[:, None], b_c[:, 1:]], 1)
        mu_eff = torch.where(
            c.mu > cfg.friction_threshold, c.mu, torch.zeros_like(c.mu)
        ).expand(C, B)
        mu_c = torch.stack([torch.zeros_like(mu_eff), mu_eff, mu_eff], 1)
        valid_rows = valid_c.repeat_interleave(3, dim=0)
        return Jc, valid_rows, b_c.reshape(3 * C, B), mu_c.reshape(3 * C, B)

    def _dynamic_block(self, k, v_pre, W, R_wb, p_wb):
        """The rows of one ball (3: the anchor points) or weld (6: the
        orientation, then the anchor points) constraint, with ERP feedback
        of the position error, and the rotation error log(R_a rel R_b^T)
        for a weld (the JAX package's batched rows)."""
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

    def _assemble(self, q, v_pre, cpoint, cnormal, cdepth, W, R_wb, p_wb, control):
        """Contact, limit, motor and ball/weld rows: J (n, nv, B), b, mu,
        valid (n, B)."""
        cfg = self.world.solver
        dt = self.world.time_step
        nv = self.world.num_dofs
        B = q.shape[-1]
        c = self._c
        blocks = []
        if self.bcollider.num_contacts > 0:
            blocks.append(self._contact_block(v_pre, cpoint, cnormal, cdepth, W))
        L = len(self.assembler.limit_rows)
        if L > 0:
            Jl = torch.zeros(L, nv, B, dtype=q.dtype, device=q.device)
            Jl[torch.arange(L, device=q.device), c.lim_dofs] = c.lim_signs
            depth_l = c.lim_signs * (c.lim_values - q[c.lim_dofs])
            valid_l = depth_l > -cfg.joint_limit_margin
            b_l = -(c.lim_signs * v_pre[c.lim_dofs]) + torch.clamp(
                depth_l * cfg.error_reduction_parameter / dt,
                0.0,
                cfg.joint_max_error_reduction_velocity,
            )
            blocks.append((Jl, valid_l, b_l, torch.zeros_like(b_l)))
        M = c.motor_J.shape[0]
        if M > 0:
            b_m = _pad(control)[c.motor_target] - torch.sum(c.motor_J * v_pre[None], dim=1)
            blocks.append((c.motor_J.expand(M, nv, B),
                           torch.ones_like(b_m, dtype=torch.bool), b_m,
                           torch.zeros_like(b_m)))
        for k in c.dyn:
            blocks.append(self._dynamic_block(k, v_pre, W, R_wb, p_wb))
        J = torch.cat([blk[0] for blk in blocks], dim=0)
        valid = torch.cat([blk[1] for blk in blocks], dim=0)
        b = torch.cat([blk[2] for blk in blocks], dim=0)
        mu = torch.cat([blk[3] for blk in blocks], dim=0)
        vf = valid.to(q.dtype)
        return J * vf[:, None, :], b * vf, mu * vf, valid

    def lcp_problem(self, q, v, control) -> LcpProblem:
        """Everything of one step before the LCP solve: smooth dynamics,
        collision and the constraint rows, as F = J L^-T, b and mu (with no
        rows: empty F, b, mu and contacts, and no collision)."""
        w = self.world
        dt = w.time_step
        B = q.shape[-1]
        c = self._c
        R_wb, p_wb, W, S_list, rels = fk(self.fw, q)
        bias = bias_forces(self.fw, q, v, rels, S_list)
        Ls = bl.block_cholesky(mass_matrix_blocks(self.fw, R_wb, p_wb, W))
        sl = self.skel_slices
        passive = -c.damping * v - c.stiffness * (q - c.rest_pos)
        tau = control * c.force_mask + passive
        v_pre = v + dt * bl.block_solve_tri_upper_t_vec(
            Ls, sl, bl.block_solve_tri_lower_vec(Ls, sl, tau - bias)
        )
        if self.num_rows == 0:
            empty = q.new_zeros(0, B)
            return LcpProblem(q.new_zeros(0, w.num_dofs, B), empty, empty, v_pre, Ls,
                              q.new_zeros(0, 3, B), q.new_zeros(0, 3, B), empty)
        cpoint, cnormal, cdepth = self.bcollider.collide(R_wb, p_wb, B)
        Jrows, b, mu, _ = self._assemble(q, v_pre, cpoint, cnormal, cdepth, W,
                                         R_wb, p_wb, control)
        # F = J L^-T  <=>  F^T = L^-1 J^T: (nv, n, B).
        Ft = bl.block_solve_tri_lower(Ls, sl, Jrows.transpose(0, 1))
        F = Ft.transpose(0, 1).contiguous()  # (n, nv, B)
        return LcpProblem(F, b, mu, v_pre, Ls, cpoint, cnormal, cdepth)

    def _lcp_options(self, fallback_cfm, fallback_gradients, ladder_mode):
        cfg = self.world.solver
        return dict(
            cfm=cfg.cfm,
            fallback_cfm=cfg.fallback_cfm if fallback_cfm is None else fallback_cfm,
            fallback_gradients=(
                cfg.fallback_gradients
                if fallback_gradients is None
                else fallback_gradients
            ),
            ladder_mode=cfg.ladder_mode if ladder_mode is None else ladder_mode,
        )

    def _inputs(self, q, v, control, z_warm):
        nv = self.world.num_dofs
        for name, x, rows in (("q", q, nv), ("v", v, nv),
                              ("control", control, nv)):
            self._check(name, x, rows)
        if z_warm is None:
            z_warm = torch.zeros(self.num_rows, q.shape[-1], dtype=q.dtype,
                                 device=q.device)
        self._check("z_warm", z_warm, self.num_rows)
        return z_warm

    def _contact_valid(self, cdepth):
        """Contact slots whose rows are live: 0 < depth <= the clipping
        depth, (C, B) bool."""
        return (cdepth > 0.0) & (cdepth <= self.world.solver.contact_clipping_depth)

    def _cap_rows(self, cdepth):
        """The capped LCP's contact rows, (3 cap, B): per world the `cap`
        slots of highest score (the depth of a live slot, else -1; ties to
        the lower slot, as jax.lax.top_k breaks them), in slot order,
        three rows each."""
        score = torch.where(self._contact_valid(cdepth), cdepth,
                            torch.full_like(cdepth, -1.0))
        order = torch.sort(score.T, dim=1, descending=True, stable=True).indices
        slots = torch.sort(order[:, : self.contact_cap], dim=1).values  # (B, cap)
        three = torch.arange(3, device=cdepth.device)
        return (3 * slots[:, :, None] + three).reshape(slots.shape[0], -1).T.contiguous()

    def lcp_blocks(self, prob: LcpProblem, z_warm, rows_idx=None):
        """The boxed LCPs one step solves, [(meta, F, b, mu, z_warm)]: one
        per island, the capped one, or the whole one; and the capped rows
        (3 cap, B), else None. rows_idx: the capped rows of an earlier call
        on the same problem (a replay gathers them again, no top-k)."""
        F, b, mu = prob.F, prob.b, prob.mu
        if self.islands is not None:
            return [
                (meta, F.index_select(0, rows).index_select(1, dofs),
                 b[rows], mu[rows], z_warm[rows])
                for (rows, dofs), (_, _, meta) in zip(self._island_idx, self.islands)
            ], None
        if self.contact_cap is None:
            return [(self.meta, F, b, mu, z_warm)], None
        C3 = 3 * self.bcollider.num_contacts
        if rows_idx is None:
            with torch.no_grad():
                rows_idx = self._cap_rows(prob.contact_depths)

        def take(X):
            idx = rows_idx.view(rows_idx.shape[0], *([1] * (X.dim() - 2)), -1)
            idx = idx.expand(rows_idx.shape[0], *X.shape[1:])
            return torch.cat([torch.gather(X[:C3], 0, idx), X[C3:]])

        return [(self.meta_cap, take(F), take(b), take(mu), take(z_warm))], rows_idx

    def _solve(self, prob: LcpProblem, z_warm, opts, saved: Optional[StepSaved] = None):
        """The step's impulses z (n, B), u = F^T z (nv, B) and its
        StepSaved; with `saved`, the replay of that solve. A world with no
        rows solves nothing: z is (0, B) and u None."""
        if self.num_rows == 0:
            return prob.b, None, StepSaved(())
        blocks, rows_idx = self.lcp_blocks(
            prob, z_warm, None if saved is None else saved.rows_idx)
        zs, lcps = [], []
        for k, (meta, F, b, mu, zw) in enumerate(blocks):
            z_k, s_k = boxed_lcp_b(meta, F, b, mu, zw, return_saved=True,
                                   saved=None if saved is None else saved.lcps[k],
                                   **opts)
            zs.append(z_k)
            lcps.append(s_k)
        n, B = prob.b.shape
        if self.islands is not None:
            # Rows of different islands have disjoint column support in F
            # (their skeletons share no dof), so the solves decouple.
            z = prob.b.new_zeros(n, B)
            u = prob.b.new_zeros(self.world.num_dofs, B)
            for (rows, dofs), blk, z_k in zip(self._island_idx, blocks, zs):
                z.index_copy_(0, rows, z_k)
                u.index_add_(0, dofs, torch.sum(blk[1] * z_k[:, None, :], dim=0))
        elif rows_idx is not None:
            # Unselected slots get no impulse this step: exact whenever a
            # world has at most `cap` penetrating slots.
            z_sel, F_sel = zs[0], blocks[0][1]
            u = torch.sum(F_sel * z_sel[:, None, :], dim=0)
            C3, k3 = 3 * self.bcollider.num_contacts, rows_idx.shape[0]
            z = torch.cat([prob.b.new_zeros(C3, B).scatter(0, rows_idx, z_sel[:k3]),
                           z_sel[k3:]])
        else:
            z, u = zs[0], None  # u = F^T z in _finish
        return z, u, StepSaved(tuple(lcps), rows_idx)

    def _finish(self, q, v, prob: LcpProblem, z, u=None) -> BatchedStepResult:
        """The impulse velocity update (u = F^T z unless given) and the
        position integration."""
        w = self.world
        if self.num_rows == 0:
            v_next = prob.v_pre
        else:
            if u is None:
                u = torch.sum(prob.F * z[:, None, :], dim=0)
            v_next = prob.v_pre + bl.block_solve_tri_upper_t_vec(
                prob.Ls, self.skel_slices, u
            )
        v_for_pos = v if w.parallel_velocity_and_position_updates else v_next
        q_next = integrate_positions(self.fw, q, v_for_pos, w.time_step)
        return BatchedStepResult(
            q=q_next,
            v=v_next,
            v_pre=prob.v_pre,
            impulses=z,
            contact_points=prob.contact_points,
            contact_normals=prob.contact_normals,
            contact_depths=prob.contact_depths,
        )

    def step(
        self,
        q: torch.Tensor,
        v: torch.Tensor,
        control: torch.Tensor,
        z_warm: Optional[torch.Tensor] = None,
        body_params: Optional[dict] = None,
        fallback_cfm: Optional[float] = None,
        fallback_gradients=None,
        ladder_mode: Optional[str] = None,
    ) -> BatchedStepResult:
        """One batched physics step on (nv, B) q, v, control and (n, B)
        warm-start impulses. fallback_cfm / fallback_gradients /
        ladder_mode override the World's SolverConfig for this call."""
        if body_params is not None:
            raise NotImplementedError(
                "body_params gradients come with the rest of the batched "
                "engine (ROADMAP queue 1 item 9.5)"
            )
        z_warm = self._inputs(q, v, control, z_warm)
        prob = self.lcp_problem(q, v, control)
        opts = self._lcp_options(fallback_cfm, fallback_gradients, ladder_mode)
        z, u, _ = self._solve(prob, z_warm, opts)
        return self._finish(q, v, prob, z, u)

    def remat_step(
        self,
        q: torch.Tensor,
        v: torch.Tensor,
        control: torch.Tensor,
        z_warm: Optional[torch.Tensor] = None,
        fallback_cfm: Optional[float] = None,
        fallback_gradients=None,
        ladder_mode: Optional[str] = None,
    ) -> BatchedStepResult:
        """`step` with its values and gradients, keeping for the backward
        only the step's inputs and its StepSaved (a few (n, B) tensors per
        LCP, and the capped rows), as
        jax.checkpoint(step, policy=LCP_REMAT_POLICY) does.

        The step runs once without a graph; its backward recomputes the
        smooth dynamics, collision, rows and F, and replays the pinned
        solve(s) on the saved masks (and the saved capped rows). The seed
        (the kernel on the card), the refine rounds, the ladder and the
        contact cap's top-k never run again.
        """
        z_warm = self._inputs(q, v, control, z_warm)
        opts = self._lcp_options(fallback_cfm, fallback_gradients, ladder_mode)
        saved = []  # the forward's StepSaved, read by the recompute

        def replay(q, v, control, z_warm):
            prob = self.lcp_problem(q, v, control)
            z, u, s = self._solve(prob, z_warm, opts, saved[0] if saved else None)
            if not saved:
                saved.append(s)
            return self._finish(q, v, prob, z, u)

        return BatchedStepResult(*_Recompute.apply(replay, q, v, control, z_warm))

    def state_step(self, state, action):
        """RL state/action step: state (2nv, B), action (na, B)."""
        nv = self.world.num_dofs
        q, v = state[:nv], state[nv:]
        res = self.step(q, v, self.action_to_forces(action))
        return torch.cat([res.q, res.v])

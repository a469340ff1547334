"""BatchedEngine: the batched forward timestep on a GPU (or the CPU).

Counterpart of nimblephysics_tpu/batched/engine.py: smooth dynamics,
collision at the pre-step q, the boxed LCP on the pre-constraint
velocity, the impulse velocity update and parallel position integration
from the pre-step velocity. Same layout at the public functions: q, v and
control are (nv, B), impulses (n_rows, B).

Device rule: the engine runs on the card unless the caller asks for the
CPU. BatchedEngine(world) with no device means "cuda" and raises where
there is no GPU; it never carries on on the CPU quietly.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, NamedTuple, Optional, Set

import numpy as np
import torch

from nimblephysics_tpu_torch.batched import linalg as bl
from nimblephysics_tpu_torch.batched.articulated import (
    FlatWorld,
    bias_forces,
    fk,
    integrate_positions,
    mass_matrix_blocks,
)
from nimblephysics_tpu_torch.batched.collision import BatchedCollider
from nimblephysics_tpu_torch.batched.lcp import boxed_lcp_b
from nimblephysics_tpu_torch.collision.collider import Collider
from nimblephysics_tpu_torch.constraint.assembly import ConstraintAssembler
from nimblephysics_tpu_torch.simulation.world import World


class BatchedStepResult(NamedTuple):
    q: torch.Tensor  # (nv, B)
    v: torch.Tensor  # (nv, B)
    v_pre: torch.Tensor  # (nv, B)
    impulses: torch.Tensor  # (n_rows, B)
    contact_points: torch.Tensor  # (C, 3, B)
    contact_normals: torch.Tensor  # (C, 3, B)
    contact_depths: torch.Tensor  # (C, B)


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
        if self.assembler.motor_rows or self.assembler.dyn_rows:
            raise NotImplementedError(
                "motor rows and dynamic weld/ball rows come with the rest of "
                "the batched engine (ROADMAP queue 1 item 9)"
            )
        if self.num_rows == 0:
            raise NotImplementedError(
                "worlds without constraint rows come with the rest of the "
                "batched engine (ROADMAP queue 1 item 9)"
            )
        self.skel_slices = world.dof_slices()
        if world.solver.contact_islands and self._build_islands() is not None:
            raise NotImplementedError(
                "worlds of two or more constraint islands come with the rest "
                "of the batched engine (ROADMAP queue 1 item 9)"
            )
        cap = world.solver.contact_cap
        if cap is not None and self.bcollider.num_contacts > cap:
            raise NotImplementedError(
                "SolverConfig.contact_cap comes with the rest of the batched "
                "engine (ROADMAP queue 1 item 9)"
            )
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

        C = self.bcollider.num_contacts
        anc = self.fw.anc
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
        )

    def _build_islands(self):
        """Partition LCP rows into static constraint islands (connected
        components over dynamic skeletons of every potential constraint
        row; static skeletons never merge components). Returns None for
        one island, else the components' row lists. The port runs only
        the one-island case."""
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
        comp_rows.pop(None, None)  # degenerate rows ride with an island
        if len(comp_rows) < 2:
            return None
        return [comp_rows[k] for k in sorted(comp_rows, key=lambda k: comp_rows[k][0])]

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

        valid_c = (cdepth > 0.0) & (cdepth <= cfg.contact_clipping_depth)
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

    def _assemble(self, q, v_pre, cpoint, cnormal, cdepth, W):
        """Contact and limit rows: J (n, nv, B), b, mu, valid (n, B)."""
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
        J = torch.cat([blk[0] for blk in blocks], dim=0)
        valid = torch.cat([blk[1] for blk in blocks], dim=0)
        b = torch.cat([blk[2] for blk in blocks], dim=0)
        mu = torch.cat([blk[3] for blk in blocks], dim=0)
        vf = valid.to(q.dtype)
        return J * vf[:, None, :], b * vf, mu * vf, valid

    def lcp_problem(self, q, v, control) -> LcpProblem:
        """Everything of one step before the LCP solve: smooth dynamics,
        collision and the constraint rows, as F = J L^-T, b and mu."""
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
        cpoint, cnormal, cdepth = self.bcollider.collide(R_wb, p_wb, B)
        Jrows, b, mu, _ = self._assemble(q, v_pre, cpoint, cnormal, cdepth, W)
        # F = J L^-T  <=>  F^T = L^-1 J^T: (nv, n, B).
        Ft = bl.block_solve_tri_lower(Ls, sl, Jrows.transpose(0, 1))
        F = Ft.transpose(0, 1).contiguous()  # (n, nv, B)
        return LcpProblem(F, b, mu, v_pre, Ls, cpoint, cnormal, cdepth)

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
                "engine (ROADMAP queue 1 item 9)"
            )
        w = self.world
        nv = w.num_dofs
        nrows = self.num_rows
        for name, x, rows in (("q", q, nv), ("v", v, nv),
                              ("control", control, nv)):
            self._check(name, x, rows)
        B = q.shape[-1]
        prob = self.lcp_problem(q, v, control)
        if z_warm is None:
            z_warm = torch.zeros(nrows, B, dtype=q.dtype, device=q.device)
        self._check("z_warm", z_warm, nrows)
        cfg = w.solver
        z = boxed_lcp_b(
            self.meta, prob.F, prob.b, prob.mu, z_warm,
            cfm=cfg.cfm,
            fallback_cfm=cfg.fallback_cfm if fallback_cfm is None else fallback_cfm,
            fallback_gradients=(
                cfg.fallback_gradients
                if fallback_gradients is None
                else fallback_gradients
            ),
            ladder_mode=cfg.ladder_mode if ladder_mode is None else ladder_mode,
        )
        u = torch.sum(prob.F * z[:, None, :], dim=0)  # (nv, B)
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

    def state_step(self, state, action):
        """RL state/action step: state (2nv, B), action (na, B)."""
        nv = self.world.num_dofs
        q, v = state[:nv], state[nv:]
        res = self.step(q, v, self.action_to_forces(action))
        return torch.cat([res.q, res.v])

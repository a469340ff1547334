"""IKInitializer: closed-form pose bootstrap from marker clouds.

Counterpart of nimblephysics_tpu/biomechanics/ik_initializer.py
(reference: dart/biomechanics/IKInitializer.hpp):

  1. SEGMENT POSES: every body with >= 3 markers gets a per-frame rigid
     transform by Kabsch between its model-frame marker offsets and the
     observed cloud.
  2. JOINT CENTERS: for joints whose parent and child both have segment
     poses, the symmetric center-of-rotation estimate (SCoRE): the linear
     least squares [R_p(t), -R_c(t)] [c_p; c_c] = p_c(t) - p_p(t).
  3. POSE RECOVERY: the joint coordinates from the relative segment
     transforms, Q_est = T_pj^-1 T_parent^-1 T_child T_cj, by closed form
     for free, ball, revolute and prismatic joints and by 8 Gauss-Newton
     steps on joint_transform for the rest.

Steps 1-2 and the closed forms run on the host in numpy, as in the JAX
package. The Gauss-Newton runs on the device (the card unless
device="cpu"), every frame of a joint at once: the frames in the trailing
axis of the joint's batched Q(q), its Jacobian by one forward-mode pass
with the dofs' tangents stacked into that axis, the systems solved
batch-first.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.biomechanics.scaled_fk import marker_table, marker_world_positions
from nimblephysics_tpu_torch.dynamics import joints as JT
from nimblephysics_tpu_torch.dynamics.skeleton import Skeleton


def _kabsch(P: np.ndarray, Q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Rigid (R, t) minimizing |R P + t - Q| (rows = points)."""
    cp, cq = P.mean(axis=0), Q.mean(axis=0)
    H = (P - cp).T @ (Q - cq)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    return R, cq - R @ cp


def _log_rot(R: np.ndarray) -> np.ndarray:
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    t = np.arccos(cos_t)
    if t < 1e-8:
        return np.zeros(3)
    if np.pi - t < 1e-5:
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        if v @ axis < 0:
            axis = -axis
        return t * axis
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return t / (2.0 * np.sin(t)) * v


class IKInitializer:
    def __init__(self, skel: Skeleton, root_translation_dofs=None, device=None):
        from nimblephysics_tpu_torch.batched.engine import _resolve_device

        self.skel = skel
        self.device = _resolve_device(device)
        self.dtype = torch.float64
        self.names, self.bodies, self.offsets, _ = marker_table(skel)
        # body -> marker row indices (static).
        self.body_markers: Dict[int, np.ndarray] = {}
        for b in range(skel.num_bodies):
            rows = np.where(self.bodies == b)[0]
            if len(rows) >= 3:
                self.body_markers[b] = rows
        j0 = skel.joints[0] if skel.joints else None
        if root_translation_dofs is None:
            root_translation_dofs = []
            if j0 is not None:
                if j0.joint_type == JT.FREE:
                    root_translation_dofs = [3, 4, 5]
                elif j0.joint_type == JT.TRANSLATIONAL:
                    root_translation_dofs = [0, 1, 2]
                elif j0.joint_type == JT.CUSTOM and j0.custom is not None:
                    # OpenSim ground-pelvis CustomJoint: the coordinates
                    # driving the three translation axes.
                    root_translation_dofs = [d for d in j0.custom.drives[3:6] if d >= 0]
        self.root_dofs = list(root_translation_dofs)
        self._joint_fit_cache = {}

    # -- step 1: per-frame segment poses -----------------------------------

    def estimate_segment_poses(
        self, observed: np.ndarray
    ) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """{body: (R (T,3,3), p (T,3), valid (T,))} for marker-rich bodies."""
        T = observed.shape[0]
        out = {}
        for b, rows in self.body_markers.items():
            local = self.offsets[rows]
            R = np.tile(np.eye(3), (T, 1, 1))
            p = np.zeros((T, 3))
            valid = np.zeros(T, dtype=bool)
            for t in range(T):
                obs = observed[t, rows]
                seen = ~np.isnan(obs[:, 0])
                if seen.sum() >= 3:
                    R[t], p[t] = _kabsch(local[seen], obs[seen])
                    valid[t] = True
            out[b] = (R, p, valid)
        return out

    # -- step 2: closed-form joint centers (SCoRE) --------------------------

    def estimate_joint_centers(
        self, observed: np.ndarray, segment_poses=None
    ) -> Dict[int, dict]:
        """{child_body: {"parent_local", "child_local", "world" (T,3),
        "rms"}} for joints with marker-rich parent AND child."""
        seg = segment_poses or self.estimate_segment_poses(observed)
        out = {}
        for bi, spec in enumerate(self.skel.joints):
            if spec.parent < 0 or bi not in seg or spec.parent not in seg:
                continue
            Rc, pc, vc = seg[bi]
            Rp, pp, vp = seg[spec.parent]
            frames = np.where(vc & vp)[0]
            if len(frames) < 5:
                continue
            # [R_p, -R_c] [c_p; c_c] = p_c - p_p  stacked over frames.
            A = np.zeros((3 * len(frames), 6))
            b = np.zeros(3 * len(frames))
            for k, t in enumerate(frames):
                A[3 * k : 3 * k + 3, :3] = Rp[t]
                A[3 * k : 3 * k + 3, 3:] = -Rc[t]
                b[3 * k : 3 * k + 3] = pc[t] - pp[t]
            x, *_ = np.linalg.lstsq(A, b, rcond=None)
            c_p, c_c = x[:3], x[3:]
            world = np.einsum("tij,j->ti", Rc[frames], c_c) + pc[frames]
            world_p = np.einsum("tij,j->ti", Rp[frames], c_p) + pp[frames]
            rms = float(
                np.sqrt(np.mean(np.sum((world - world_p) ** 2, axis=1)))
            )
            full_world = np.full((observed.shape[0], 3), np.nan)
            full_world[frames] = 0.5 * (world + world_p)
            out[bi] = {
                "parent_local": c_p,
                "child_local": c_c,
                "world": full_world,
                "rms": rms,
            }
        return out

    # -- step 3: pose recovery ----------------------------------------------

    def _joint_fit(self, spec):
        """The cached Gauss-Newton of one joint: Q_est (F, 3, 4) -> q (F,
        nd), 8 steps from q = 0 with 1e-8 damping on the 12-entry
        transform residual, every frame at once."""
        if id(spec) in self._joint_fit_cache:
            return self._joint_fit_cache[id(spec)]
        from nimblephysics_tpu_torch.batched.articulated import _joint_Q

        fw = JT._joint_world(spec)
        nd = spec.num_dofs
        dev, dt = self.device, self.dtype
        c = fw.tensors(dt, dev)
        eye = torch.eye(nd, dtype=dt, device=dev)

        def q34(q):  # (nd, B) -> (B, 12)
            Rq, pq, _ = _joint_Q(c, q)
            return torch.cat([Rq[0].expand(3, 3, q.shape[1]), pq[0].expand(3, q.shape[1])[:, None]], dim=1).permute(2, 0, 1).reshape(-1, 12)

        def fit(target):
            F = target.shape[0]
            target = target.reshape(F, 12)
            tangents = eye.repeat_interleave(F, dim=1)  # (nd, nd F): dof d at frames d F...
            q = torch.zeros(nd, F, dtype=dt, device=dev)
            for _ in range(8):
                Q, dQ = torch.func.jvp(q34, (q.repeat(1, nd),), (tangents,))
                r = Q[:F] - target
                J = dQ.reshape(nd, F, 12).permute(1, 2, 0)  # (F, 12, nd)
                Jt = J.transpose(1, 2)
                dq = torch.linalg.solve(Jt @ J + 1e-8 * eye, Jt @ r[..., None])[..., 0]
                q = q - dq.T
            return q.T

        self._joint_fit_cache[id(spec)] = fit
        return fit

    def _fit_joint_qs(self, spec, Q_est: np.ndarray) -> np.ndarray:
        """Invert Q(q) ~= Q_est (F, 4, 4) for any joint type: closed forms
        for free, ball, revolute and prismatic joints, the cached
        Gauss-Newton (_joint_fit) for the rest (euler, universal, custom
        and the biomechanics joints). Returns (F, nd)."""
        nd = spec.num_dofs
        tt = spec.joint_type
        F = Q_est.shape[0]
        q0 = np.zeros((F, nd))
        if tt == JT.FREE:
            for f in range(F):
                q0[f, :3] = _log_rot(Q_est[f, :3, :3])
            q0[:, 3:6] = Q_est[:, :3, 3]
            return q0
        if tt == JT.BALL:
            return np.stack([_log_rot(Q_est[f, :3, :3]) for f in range(F)])
        if tt == JT.REVOLUTE:
            for f in range(F):
                q0[f, 0] = _log_rot(Q_est[f, :3, :3]) @ spec.axes[0]
            return q0
        if tt == JT.PRISMATIC:
            q0[:, 0] = Q_est[:, :3, 3] @ spec.axes[0]
            return q0
        target = torch.as_tensor(Q_est[:, :3, :], dtype=self.dtype, device=self.device)
        return self._joint_fit(spec)(target).cpu().numpy()

    def initialize(self, observed: np.ndarray, use_segment_poses: bool = True) -> np.ndarray:
        """(T, M, 3) NaN-masked markers -> (T, nq) initial poses."""
        T = observed.shape[0]
        nq = self.skel.num_dofs
        poses = np.zeros((T, nq))
        seg = self.estimate_segment_poses(observed) if use_segment_poses else {}

        def transforms(b, frames):
            out = np.tile(np.eye(4), (len(frames), 1, 1))
            out[:, :3, :3] = seg[b][0][frames]
            out[:, :3, 3] = seg[b][1][frames]
            return out

        for bi, spec in enumerate(self.skel.joints):
            if spec.num_dofs == 0 or bi not in seg:
                continue
            ok = seg[bi][2].copy()
            if spec.parent >= 0:
                ok &= seg[spec.parent][2] if spec.parent in seg else False
            frames = np.where(ok)[0]
            if not len(frames):
                continue
            T_child = transforms(bi, frames)
            T_parent = (np.tile(np.eye(4), (len(frames), 1, 1)) if spec.parent < 0
                        else transforms(spec.parent, frames))
            # Q_est = T_pj^-1 T_parent^-1 T_child T_cj.
            Q = np.linalg.inv(spec.T_pj) @ np.linalg.inv(T_parent) @ T_child @ spec.T_cj
            s = spec.q_index
            poses[frames, s : s + spec.num_dofs] = self._fit_joint_qs(spec, Q)

        # Root translation fallback: centroid alignment when the root body
        # itself has no Kabsch estimate in a frame.
        if self.root_dofs:
            model = None
            for t in range(T):
                if 0 in seg and seg[0][2][t]:
                    continue
                obs = observed[t]
                seen = ~np.isnan(obs[:, 0])
                if seen.sum() < 3:
                    continue
                if model is None:
                    model = marker_world_positions(
                        self.skel, torch.zeros(nq, dtype=torch.float64), self.bodies,
                        torch.as_tensor(self.offsets, dtype=torch.float64)).numpy()
                delta = obs[seen].mean(axis=0) - model.mean(axis=0)
                for k, d in enumerate(self.root_dofs[:3]):
                    poses[t, d] = delta[k]
        return poses


def _rot_about(axis: np.ndarray, angle: float) -> np.ndarray:
    K = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)

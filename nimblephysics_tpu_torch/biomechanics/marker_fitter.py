"""MarkerFitter: bilevel mocap fitting of body scales, marker offsets and
per-frame poses.

Counterpart of nimblephysics_tpu/biomechanics/marker_fitter.py (reference:
dart/biomechanics/MarkerFitter.hpp:596-605): fit body scales, marker
offsets and poses to observed marker clouds, NaN = occluded.

  inner: damped Gauss-Newton IK on every frame at once, clipped to the
    joint limits, with a small Tikhonov pull toward the neutral pose;
  outer: Adam on (log body scales, marker offset changes) through the
    total masked error, or with outer_solver="gn" one Levenberg-damped
    Gauss-Newton step an alternation on the same variables (no
    anthropometric prior: with one set, Adam runs).

Layout: frames in the trailing axis, as worlds are in the batched
engine: poses (nq, T), observations (M, 3, T). Each IK iteration is one
batched fk of the T frames, the markers' q-Jacobian in closed form from
fk's world screw axes (scaled_fk.marker_jacobians) and T 38 x 38 systems
solved batch-first; the outer Gauss-Newton step forms the (T M 3 + n_theta)
x n_theta Jacobian once, in closed form, and keeps its accept/reject
decision on the device. No loop runs over frames: the launches of an
iteration do not depend on T. Runs on the card unless device="cpu", in
float64.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.biomechanics.scaled_fk import (
    marker_jacobians,
    marker_table,
    marker_world_positions_frames,
    scale_coefficients,
)
from nimblephysics_tpu_torch.dynamics.skeleton import Skeleton


@dataclasses.dataclass
class MarkerFitResult:
    """Reference parity: MarkerInitialization / MarkerFitResult."""

    body_scales: np.ndarray  # (nb, 3)
    marker_offsets: np.ndarray  # (M, 3)
    poses: np.ndarray  # (T, nq)
    avg_marker_error: float  # meters (RMS over observed markers)
    per_frame_error: np.ndarray  # (T,)
    marker_names: List[str]


def _clip_jax(x, lo, hi):
    """min(max(x, lo), hi) with the JAX package's gradient: half on a tie
    with a bound (torch.maximum and torch.minimum split it as lax does)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def _clip_jax_grad(x, lo, hi):
    """d _clip_jax / dx, elementwise."""
    y = torch.clamp(x, min=lo)
    dmax = (x > lo).to(x.dtype) + 0.5 * (x == lo).to(x.dtype)
    dmin = (y < hi).to(x.dtype) + 0.5 * (y == hi).to(x.dtype)
    return dmax * dmin


class MarkerFitter:
    def __init__(
        self,
        skel: Skeleton,
        markers: Optional[Dict[str, Tuple[int, np.ndarray, bool]]] = None,
        regularize_scales: float = 1.0,
        regularize_offsets: float = 10.0,
        regularize_tracking_offsets: float = 0.05,
        scale_bounds: Tuple[float, float] = (0.7, 1.4),
        anthropometrics=None,
        anthropometric_weight: float = 1e-3,
        scale_groups=None,
        device=None,
    ):
        """anthropometrics: an optional biomechanics.Anthropometrics prior,
        whose log-pdf over the body scales joins the outer objective;
        scale_groups: an optional biomechanics.ScaleGroups sharing one
        scale per symmetric group. device: the card unless "cpu"."""
        from nimblephysics_tpu_torch.batched.engine import _resolve_device

        self.skel = skel
        self.anthro = anthropometrics
        self.anthro_w = anthropometric_weight
        self.groups = scale_groups
        self.device = _resolve_device(device)
        self.dtype = torch.float64
        if markers is not None:
            for name, (b, off, fixed) in markers.items():
                skel.add_marker(name, b, off, fixed)
        (self.marker_names, self._bodies, self._offsets0, self._fixed) = marker_table(skel)
        self.reg_scales = regularize_scales
        self.reg_offsets = regularize_offsets
        self.reg_tracking = regularize_tracking_offsets
        self.scale_bounds = scale_bounds
        self._idx = torch.as_tensor(self._bodies, dtype=torch.long, device=self.device)
        self._off0 = self._t(self._offsets0)
        # Each marker's offset regularization weight: anatomical ("fixed")
        # markers strongly, tracking markers weakly, but all movable.
        self._w_off = self._t(np.where(self._fixed, regularize_offsets,
                                       regularize_tracking_offsets))
        self._coef = self._t(scale_coefficients(skel))
        self._q_lo = self._t(np.nan_to_num(skel.position_lower_limits(), neginf=-1e9))
        self._q_hi = self._t(np.nan_to_num(skel.position_upper_limits(), posinf=1e9))
        self._q_neutral = torch.minimum(torch.maximum(torch.zeros_like(self._q_lo),
                                                      self._q_lo), self._q_hi)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=self.dtype,
                               device=self.device)

    # -- the inner problem ------------------------------------------------

    def ik_step(self, q, scales, offsets, obs, mask, pose_regularization: float = 1e-4,
                joint_limits: bool = True) -> torch.Tensor:
        """One damped Gauss-Newton IK iteration on every frame: q (nq, T),
        scales (nb, 3), offsets (M, 3), obs (M, 3, T) with zeros where
        occluded, mask (M, T) bool -> q (nq, T)."""
        nq, T = q.shape
        lam = pose_regularization
        pos, J_q = marker_jacobians(self.skel, q, self._idx, offsets, scales, wrt=("q",))
        m = mask[:, None, :]
        r = torch.where(m, pos - obs, 0.0).permute(2, 0, 1).reshape(T, -1)
        J = (J_q * m[:, :, None, :]).permute(3, 0, 1, 2).reshape(T, -1, nq)
        Jt = J.transpose(1, 2)
        eye = torch.eye(nq, dtype=q.dtype, device=q.device)
        rhs = Jt @ r[..., None] + lam * (q.T - self._q_neutral)[..., None]
        dq = torch.linalg.solve(Jt @ J + (1e-6 + lam) * eye, rhs)[..., 0]
        q_new = q - dq.T
        if joint_limits:
            q_new = torch.minimum(torch.maximum(q_new, self._q_lo[:, None]), self._q_hi[:, None])
        return q_new

    # -- the outer problem ------------------------------------------------

    def _scales_of(self, log_s):
        lo, hi = self.scale_bounds
        s = _clip_jax(torch.exp(log_s), lo, hi)
        return self.groups.expand(s) if self.groups else s

    def _theta_residuals(self, theta, poses, obs, mask, jacobian: bool = False):
        """The Gauss-Newton outer residuals of theta = [log_s; d_off]: the
        masked marker errors (T, M, 3) over sqrt(the observed count), then
        the regularizer rows; with jacobian, also d(residuals)/d(theta)."""
        M = len(self._bodies)
        n_s = theta.shape[0] - 3 * M
        log_s = theta[:n_s].reshape(-1, 3)
        d_off = theta[n_s:].reshape(M, 3)
        scales = self._scales_of(log_s)
        offsets = self._off0 + d_off
        norm = torch.rsqrt(torch.clamp(mask.sum().to(theta.dtype), min=1.0))
        reg_s = torch.full((n_s,), (self.reg_scales / n_s) ** 0.5, dtype=theta.dtype,
                           device=theta.device)
        reg_o = torch.sqrt(self._w_off / (M * 3)).repeat_interleave(3)
        m = mask[:, None, :]
        if not jacobian:
            pos = marker_world_positions_frames(self.skel, poses, self._idx, offsets, scales)
        else:
            pos, J_s, J_o = marker_jacobians(self.skel, poses, self._idx, offsets, scales,
                                             self._coef, wrt=("scales", "offsets"))
        r = torch.cat([(torch.where(m, pos - obs, 0.0) * norm).permute(2, 0, 1).reshape(-1),
                       reg_s * log_s.reshape(-1), reg_o * d_off.reshape(-1)])
        if not jacobian:
            return r
        T = poses.shape[1]
        if self.groups:  # each group's columns: the sum of its bodies'
            member_of = torch.as_tensor(self.groups.member_of, device=theta.device)
            J_s = J_s.new_zeros(M, 3, self.groups.n_groups, 3, T).index_add_(2, member_of, J_s)
        lo, hi = self.scale_bounds
        e = torch.exp(log_s)
        J_s = J_s * (e * _clip_jax_grad(e, lo, hi))[None, None, :, :, None]
        w = (m * norm).to(theta.dtype)  # (M, 1, T)
        J_s = (J_s * w[:, :, None, None, :]).permute(4, 0, 1, 2, 3).reshape(T * M * 3, n_s)
        eye_m = torch.eye(M, dtype=theta.dtype, device=theta.device)
        J_o = torch.einsum("miat,mn->tmina", J_o * w[:, :, None, :], eye_m).reshape(
            T * M * 3, M * 3)
        J = torch.cat([torch.cat([J_s, J_o], dim=1), torch.diag(torch.cat([reg_s, reg_o]))])
        return r, J

    def _gn_outer_step(self, theta, poses, obs, mask, mu):
        """One Levenberg-damped Gauss-Newton step; accepted (and mu / 3)
        if it lowers the residual, else mu x 4, all on the device."""
        r, J = self._theta_residuals(theta, poses, obs, mask, jacobian=True)
        g = J.T @ r
        H = J.T @ J
        D = torch.diag(torch.clamp(torch.diagonal(H), min=1e-10))
        step = torch.linalg.solve(H + mu * D, -g)
        f0 = torch.sum(r * r)
        r1 = self._theta_residuals(theta + step, poses, obs, mask)
        accept = torch.sum(r1 * r1) < f0
        theta = torch.where(accept, theta + step, theta)
        mu = torch.where(accept, torch.clamp(mu / 3.0, min=1e-10), mu * 4.0)
        return theta, mu

    def _outer_loss(self, log_s, d_off, poses, obs, mask):
        scales = self._scales_of(log_s)
        offsets = self._off0 + d_off
        pos = marker_world_positions_frames(self.skel, poses, self._idx, offsets, scales)
        err = torch.where(mask[:, None, :], pos - obs, 0.0)
        data = torch.sum(err * err) / torch.clamp(mask.sum().to(log_s.dtype), min=1.0)
        reg = self.reg_scales * torch.mean(log_s**2) + torch.mean(self._w_off[:, None] * d_off**2)
        if self.anthro is not None:
            reg = reg - self.anthro_w * self.anthro.log_pdf(scales)
        return data + reg

    def fit(
        self,
        observed: np.ndarray,  # (T, M, 3), NaN = occluded
        q_init: Optional[np.ndarray] = None,
        outer_iterations: int = 60,
        ik_iterations: int = 8,
        lr_scales: float = 0.02,
        lr_offsets: float = 0.005,
        clean_traces: bool = False,
        dt: Optional[float] = None,
        joint_limits: bool = True,
        pose_regularization: float = 1e-4,
        outer_solver: str = "adam",
    ) -> MarkerFitResult:
        """Bilevel fit (reference: MarkerFitter::runKinematicsPipeline),
        alternating the inner IK and one outer step: Adam, or with
        outer_solver="gn" (and no anthropometric prior) a Levenberg-damped
        Gauss-Newton step on theta = [log_s; d_off]."""
        skel = self.skel
        nq, nb = skel.num_dofs, skel.num_bodies
        if clean_traces:
            from nimblephysics_tpu_torch.biomechanics.marker_fixer import clean_marker_traces

            observed, _report = clean_marker_traces(observed, dt=dt if dt is not None else 0.01)
        observed = np.asarray(observed, dtype=np.float64)
        T, M, _ = observed.shape
        if M != len(self.marker_names):
            raise ValueError(f"{M} observed markers, the skeleton has {len(self.marker_names)}")
        # Fill first: no NaN reaches a where's other branch.
        obs = self._t(np.nan_to_num(observed, nan=0.0).transpose(1, 2, 0))  # (M, 3, T)
        mask = torch.as_tensor(~np.isnan(observed[..., 0]).T, device=self.device)  # (M, T)
        offsets0 = self._off0
        poses = torch.zeros(nq, T, dtype=self.dtype, device=self.device)
        if q_init is not None:
            q0 = torch.as_tensor(q_init, dtype=self.dtype).to(self.device)
            poses = poses + (q0.T if q0.dim() == 2 else q0[:, None])
        n_sp = self.groups.n_groups if self.groups else nb
        log_scales = torch.zeros(n_sp, 3, dtype=self.dtype, device=self.device)
        d_offsets = torch.zeros(M, 3, dtype=self.dtype, device=self.device)

        def ik(poses, log_s, d_off):
            scales, offsets = self._scales_of(log_s), offsets0 + d_off
            for _ in range(ik_iterations):
                poses = self.ik_step(poses, scales, offsets, obs, mask, pose_regularization,
                                     joint_limits)
            return poses

        if outer_solver == "gn" and self.anthro is None:
            n_s = n_sp * 3
            theta = torch.cat([log_scales.reshape(-1), d_offsets.reshape(-1)])
            mu = torch.tensor(1e-3, dtype=self.dtype, device=self.device)
            for _ in range(outer_iterations):
                poses = ik(poses, theta[:n_s].reshape(n_sp, 3), theta[n_s:].reshape(M, 3))
                theta, mu = self._gn_outer_step(theta, poses, obs, mask, mu)
            log_scales, d_offsets = theta[:n_s].reshape(n_sp, 3), theta[n_s:].reshape(M, 3)
        else:
            m_s, v_s = torch.zeros_like(log_scales), torch.zeros_like(log_scales)
            m_o, v_o = torch.zeros_like(d_offsets), torch.zeros_like(d_offsets)
            for it in range(outer_iterations):
                poses = ik(poses, log_scales, d_offsets)
                ls = log_scales.detach().requires_grad_(True)
                do = d_offsets.detach().requires_grad_(True)
                gs, go = torch.autograd.grad(self._outer_loss(ls, do, poses, obs, mask),
                                             (ls, do))
                t = it + 1.0
                m_s = 0.9 * m_s + 0.1 * gs
                v_s = 0.999 * v_s + 0.001 * gs * gs
                log_scales = log_scales - lr_scales * (m_s / (1 - 0.9**t)) / (
                    torch.sqrt(v_s / (1 - 0.999**t)) + 1e-8)
                m_o = 0.9 * m_o + 0.1 * go
                v_o = 0.999 * v_o + 0.001 * go * go
                d_offsets = d_offsets - lr_offsets * (m_o / (1 - 0.9**t)) / (
                    torch.sqrt(v_o / (1 - 0.999**t)) + 1e-8)

        with torch.no_grad():
            scales = self._scales_of(log_scales)
            offsets = offsets0 + d_offsets
            poses = ik(poses, log_scales, d_offsets)
            # Final per-frame RMS (meters).
            pred = marker_world_positions_frames(skel, poses, self._idx, offsets, scales)
            err2 = torch.sum(torch.where(mask[:, None, :], (pred - obs) ** 2, 0.0), dim=1)
            per_frame = torch.sqrt(torch.sum(err2, dim=0)
                                   / torch.clamp(mask.sum(dim=0).to(self.dtype), min=1.0))
        return MarkerFitResult(
            body_scales=scales.cpu().numpy(),
            marker_offsets=offsets.cpu().numpy(),
            poses=poses.T.cpu().numpy(),
            avg_marker_error=float(per_frame.mean()),
            per_frame_error=per_frame.cpu().numpy(),
            marker_names=self.marker_names,
        )

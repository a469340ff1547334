"""SimpleFeatherstone: flat-array O(n) ABA forward dynamics of a chain.

Counterpart of nimblephysics_tpu/dynamics/simple_featherstone.py.
Reference parity: dart/dynamics/SimpleFeatherstone.hpp:17-75
(`JointAndBody` flat arrays + `FeatherstoneScratchSpace` recursion), the
reference's stripped-down articulated-body algorithm for single-dof
serial structures. The JAX package runs its three passes as `lax.scan`s;
here they are loops over the chain's bodies (parent = i - 1 or world).

All quantities are body-frame spatial vectors [w; v].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nimblephysics_tpu_torch.dynamics import joints as JT
from nimblephysics_tpu_torch.dynamics.skeleton import Skeleton, _spatial_inertias
from nimblephysics_tpu_torch.math import lie


class FlatChain(NamedTuple):
    """Stacked per-joint constants (the reference's JointAndBody arrays)."""

    S: torch.Tensor  # (n, 6) joint motion subspace in the child body frame
    T_static: torch.Tensor  # (n, 4, 4) zeros, kept for the JAX layout
    # T_rel(q) = T_pj Q(q) T_cj^-1: T_pj and T_cj^-1 are stored apart to
    # rebuild T_rel(q) in the outward pass.
    T_pj: torch.Tensor  # (n, 4, 4)
    T_cj_inv: torch.Tensor  # (n, 4, 4)
    axis: torch.Tensor  # (n, 3)
    is_prismatic: torch.Tensor  # (n,) bool
    G: torch.Tensor  # (n, 6, 6) spatial inertias


def flatten_chain(skel: Skeleton, dtype=torch.float64, device="cpu") -> FlatChain:
    """Populate flat arrays from a serial single-dof skeleton
    (reference: SimpleFeatherstone::populateFromSkeleton)."""
    n = skel.num_bodies
    S = np.zeros((n, 6))
    axis = np.zeros((n, 3))
    prism = np.zeros(n, dtype=bool)
    T_pj = np.zeros((n, 4, 4))
    T_cj_inv = np.zeros((n, 4, 4))
    for i, spec in enumerate(skel.joints):
        assert spec.num_dofs == 1 and spec.joint_type in (
            JT.REVOLUTE,
            JT.PRISMATIC,
        ), "SimpleFeatherstone handles single-dof revolute/prismatic chains"
        assert spec.parent == i - 1, "SimpleFeatherstone expects a chain"
        a = np.asarray(spec.axes[0], dtype=np.float64)
        axis[i] = a
        prism[i] = spec.joint_type == JT.PRISMATIC
        T_pj[i] = spec.T_pj
        T_cj_inv[i] = np.linalg.inv(spec.T_cj)
        Ad_cj = lie.Ad(torch.as_tensor(np.asarray(spec.T_cj, np.float64))).numpy()
        s_joint = (
            np.concatenate([np.zeros(3), a])
            if prism[i]
            else np.concatenate([a, np.zeros(3)])
        )
        S[i] = Ad_cj @ s_joint
    t = dict(dtype=dtype, device=device)
    G = torch.stack(_spatial_inertias(skel, dtype, device=device))
    return FlatChain(
        S=torch.as_tensor(S, **t),
        T_static=torch.zeros(n, 4, 4, **t),
        T_pj=torch.as_tensor(T_pj, **t),
        T_cj_inv=torch.as_tensor(T_cj_inv, **t),
        axis=torch.as_tensor(axis, **t),
        is_prismatic=torch.as_tensor(prism, device=device),
        G=G,
    )


def aba_forward_dynamics(
    chain: FlatChain,
    q: torch.Tensor,
    dq: torch.Tensor,
    tau: torch.Tensor,
    gravity: torch.Tensor,
) -> torch.Tensor:
    """O(n) articulated-body algorithm over the chain; returns ddq.

    Three passes (reference: SimpleFeatherstone::forwardDynamics's
    backward/forward passes over scratch space):
      1. outward: transforms, velocities, bias terms;
      2. inward: articulated inertias + bias forces;
      3. outward: accelerations.
    """
    n = q.shape[-1]
    t = dict(dtype=q.dtype, device=q.device)
    gravity = torch.as_tensor(gravity, **t)

    # Per-joint relative transform (all joints at once).
    aq = chain.axis * q[:, None]
    prism = chain.is_prismatic[:, None]
    R = torch.where(prism[..., None], torch.eye(3, **t).expand(n, 3, 3),
                    lie.exp_map_rot(aq))
    p = torch.where(prism, aq, torch.zeros_like(aq))
    T_rel = chain.T_pj @ lie.rp_to_transform(R, p) @ chain.T_cj_inv
    Ad_inv = lie.Ad(lie.transform_inv(T_rel))

    # 1. outward: V_i = Ad(T^-1) V_parent + S_i dq_i
    V_par = torch.zeros(6, **t)
    V = []
    for i in range(n):
        V_par = Ad_inv[i] @ V_par + chain.S[i] * dq[i]
        V.append(V_par)
    V = torch.stack(V)
    # Velocity products: c_i = ad(V_i) S_i dq_i; bias force
    # p_i = -ad*(V_i)(G_i V_i).
    cvel = lie.ad_apply(V, chain.S * dq[:, None])
    pbias = -lie.dad_apply(V, (chain.G @ V[..., None])[..., 0])

    # 2. inward: articulated inertia G^A and bias p^A.
    GA, pA, u, sGs = [None] * n, [None] * n, [None] * n, [None] * n
    GA_child = torch.zeros(6, 6, **t)
    pA_child = torch.zeros(6, **t)
    Ad_child = torch.zeros(6, 6, **t)
    for i in reversed(range(n)):
        Si = chain.S[i]
        GA_i = chain.G[i] + Ad_child.T @ GA_child @ Ad_child
        pA_i = pbias[i] + Ad_child.T @ pA_child
        # Project through the joint of THIS body for the parent's view:
        GS = GA_i @ Si
        sGs_i = Si @ GS + 1e-12
        u_i = tau[i] - Si @ (pA_i + GA_i @ cvel[i])
        GA_child = GA_i - torch.outer(GS, GS) / sGs_i
        pA_child = pA_i + GA_i @ cvel[i] + GS * (u_i / sGs_i)
        Ad_child = Ad_inv[i]
        GA[i], pA[i], u[i], sGs[i] = GA_i, pA_i, u_i, sGs_i

    # 3. outward: accelerations. u already holds the velocity-bias
    # contribution through p^a = p^A + G^A c, so ddq uses only the
    # transformed parent acceleration.
    A_par = torch.cat([torch.zeros(3, **t), -gravity])
    ddq = []
    for i in range(n):
        A_t = Ad_inv[i] @ A_par
        ddq_i = (u[i] - chain.S[i] @ (GA[i] @ A_t)) / sGs[i]
        A_par = A_t + cvel[i] + chain.S[i] * ddq_i
        ddq.append(ddq_i)
    return torch.stack(ddq)

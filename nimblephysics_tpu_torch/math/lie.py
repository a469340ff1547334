"""Lie-group maths: SO(3)/SE(3) exp and log, adjoints, the SO(3) left and
right Jacobians and their inverses and time derivatives, Euler angles.

Counterpart of nimblephysics_tpu/math/lie.py, with its conventions:
spatial vectors [angular; linear], rotation-vector coordinates,
Ad(T) = [[R, 0], [[p]x R, R]] and ad(V) = [[[w]x, 0], [[v]x, [w]x]].
Every function takes leading batch dimensions, (..., 3), (..., 4, 4).
The SO(3) maps run the arithmetic of batched/linalg.py (exp_so3,
log_so3, so3_right_jacobian_b and the coefficient rates of
so3_coeff_rates, with their small-angle branches) on the flattened batch;
the time derivatives of the Jacobians are written in closed form from
those rates.
"""

from __future__ import annotations

import torch

from nimblephysics_tpu_torch.batched import linalg as bl

# theta^2 below which _jac_inv_coeff takes its Taylor series: the generic
# form 1/t^2 - (1 + cos t)/(2 t sin t) cancels ~1/t^2 of its magnitude.
_INV_EPS = 1e-6


def _cols(w):
    """(..., 3) -> (3, N): the batch flattened into batched/linalg's
    trailing axis."""
    return w.reshape(-1, 3).T


def _mats(M, shape):
    """(3, 3, N) -> shape + (3, 3)."""
    return M.permute(2, 0, 1).reshape(*shape, 3, 3)


def _vecs(x, shape):
    """(3, N) -> shape + (3,)."""
    return x.T.reshape(*shape, 3)


def skew(v):
    """(..., 3) -> (..., 3, 3) with [v]x u = v x u."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def unskew(m):
    """The antisymmetric part of (..., 3, 3) as a vector (..., 3)."""
    return torch.stack([
        0.5 * (m[..., 2, 1] - m[..., 1, 2]),
        0.5 * (m[..., 0, 2] - m[..., 2, 0]),
        0.5 * (m[..., 1, 0] - m[..., 0, 1]),
    ], dim=-1)


def exp_map_rot(w):
    """Rodrigues: rotation vector (..., 3) -> rotation matrix (..., 3, 3)."""
    return _mats(bl.exp_so3(_cols(w)), w.shape[:-1])


def log_map_rot(R):
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3), safe at 0
    and near pi."""
    shape = R.shape[:-2]
    return _vecs(bl.log_so3(R.reshape(-1, 3, 3).permute(1, 2, 0)), shape)


def so3_right_jacobian(w):
    """J_r(w) = I - b [w]x + c [w]x^2: body angular velocity = J_r(q) qdot."""
    return _mats(bl.so3_right_jacobian_b(_cols(w)), w.shape[:-1])


def so3_left_jacobian(w):
    """J_l(w) = J_r(-w) = I + b [w]x + c [w]x^2."""
    return so3_right_jacobian(-w)


def _jac_inv_coeff(theta_sq):
    """D = 1/t^2 - (1 + cos t)/(2 t sin t), with its Taylor series below
    _INV_EPS behind a double where."""
    small = theta_sq < _INV_EPS
    ts = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    t = torch.sqrt(ts)
    big = 1.0 / ts - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t))
    taylor = 1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq / 30240.0
    return torch.where(small, taylor, big)


def _jac_inv(w, sign):
    W = skew(w)
    D = _jac_inv_coeff(torch.sum(w * w, dim=-1))[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + sign * 0.5 * W + D * (W @ W)


def so3_left_jacobian_inv(w):
    """J_l(w)^-1 = I - [w]x / 2 + D [w]x^2."""
    return _jac_inv(w, -1.0)


def so3_right_jacobian_inv(w):
    """J_r(w)^-1 = I + [w]x / 2 + D [w]x^2."""
    return _jac_inv(w, 1.0)


def _jacobian_time_deriv(w, dw, sign):
    """d/dt (I + sign b [w]x + c [w]x^2) along w-dot = dw, from the radial
    rates b'(t)/t and c'(t)/t of so3_coeff_rates."""
    shape = w.shape[:-1]
    _, b, c, _, db, dc = bl.so3_coeff_rates(_cols(w))
    s = torch.sum(w * dw, dim=-1).reshape(-1)
    K, dK = skew(w).reshape(-1, 3, 3), skew(dw).reshape(-1, 3, 3)
    out = ((sign * db * s)[:, None, None] * K + (sign * b)[:, None, None] * dK
           + (dc * s)[:, None, None] * (K @ K) + c[:, None, None] * (dK @ K + K @ dK))
    return out.reshape(*shape, 3, 3)


def so3_right_jacobian_time_deriv(w, dw):
    """d/dt J_r(w(t)) with w-dot = dw (closed form)."""
    return _jacobian_time_deriv(w, dw, -1.0)


def so3_left_jacobian_time_deriv(w, dw):
    """d/dt J_l(w(t)) with w-dot = dw (closed form)."""
    return _jacobian_time_deriv(w, dw, 1.0)


def so3_right_jacobian_time_deriv_deriv(w, dw, index: int):
    """d/dw_index of so3_right_jacobian_time_deriv(w, dw), by forward-mode
    differentiation (not on the step's path)."""
    basis = torch.zeros_like(w)
    basis[..., index] = 1.0
    return torch.func.jvp(
        lambda ww: so3_right_jacobian_time_deriv(ww, dw), (w,), (basis,))[1]


def rp_to_transform(R, p):
    """A 4x4 homogeneous transform from R (..., 3, 3) and p (..., 3)."""
    shape = torch.broadcast_shapes(R.shape[:-2], p.shape[:-1])
    R = R.expand(*shape, 3, 3)
    p = p.expand(*shape, 3)
    bottom = torch.zeros(*shape, 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, p[..., None]], dim=-1), bottom], dim=-2)


def transform_inv(T):
    """The inverse of a rigid transform."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rp_to_transform(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def transform_point(T, pt):
    return (T[..., :3, :3] @ pt[..., None])[..., 0] + T[..., :3, 3]


def transform_vector(T, vec):
    return (T[..., :3, :3] @ vec[..., None])[..., 0]


def exp_map(xi):
    """SE(3) exp: twist [w; v] (..., 6) -> (exp([w]x), J_l(w) v)."""
    w, v = xi[..., :3], xi[..., 3:]
    return rp_to_transform(exp_map_rot(w), (so3_left_jacobian(w) @ v[..., None])[..., 0])


def log_map(T):
    """SE(3) log: 4x4 transform -> twist [w; J_l(w)^-1 p]."""
    w = log_map_rot(T[..., :3, :3])
    v = (so3_left_jacobian_inv(w) @ T[..., :3, 3:])[..., 0]
    return torch.cat([w, v], dim=-1)


def Ad(T):
    """6x6 adjoint [[R, 0], [[p]x R, R]]: V_A = Ad(T_AB) V_B."""
    R = T[..., :3, :3]
    pR = skew(T[..., :3, 3]) @ R
    zero = torch.zeros_like(R)
    return torch.cat([torch.cat([R, zero], dim=-1), torch.cat([pR, R], dim=-1)], dim=-2)


def Ad_inv(T):
    return Ad(transform_inv(T))


def dAd(T):
    """Dual adjoint Ad(T)^T, mapping wrenches."""
    return Ad(T).transpose(-1, -2)


def ad(V):
    """6x6 adjoint of a twist: ad(V) W = [V, W]."""
    W, Vx = skew(V[..., :3]), skew(V[..., 3:])
    zero = torch.zeros_like(W)
    return torch.cat([torch.cat([W, zero], dim=-1), torch.cat([Vx, W], dim=-1)], dim=-2)


def ad_apply(V, W6):
    """ad(V) W without forming the matrix."""
    w, v = V[..., :3], V[..., 3:]
    ww, wv = W6[..., :3], W6[..., 3:]
    return torch.cat([torch.cross(w, ww, dim=-1),
                      torch.cross(v, ww, dim=-1) + torch.cross(w, wv, dim=-1)], dim=-1)


def dad_apply(V, F):
    """ad(V)^T F = [-w x m - v x f; -w x f] for F = [m; f]."""
    w, v = V[..., :3], V[..., 3:]
    m, f = F[..., :3], F[..., 3:]
    return torch.cat([-torch.cross(w, m, dim=-1) - torch.cross(v, f, dim=-1),
                      -torch.cross(w, f, dim=-1)], dim=-1)


_AXES = {"x": 0, "y": 1, "z": 2}


def _axis_rot(axis: str, angle):
    a = torch.zeros(*angle.shape, 3, dtype=angle.dtype, device=angle.device)
    a[..., _AXES[axis]] = 1.0
    return exp_map_rot(a * angle[..., None])


def euler_to_matrix(angles, order: str = "xyz"):
    """Intrinsic Euler angles: R = R_o0(a0) R_o1(a1) R_o2(a2)."""
    order = order.lower()
    R = _axis_rot(order[0], angles[..., 0])
    for i, ax in enumerate(order[1:], start=1):
        R = R @ _axis_rot(ax, angles[..., i])
    return R


def matrix_to_euler_xyz(R):
    """Intrinsic XYZ angles of R = Rx(a) Ry(b) Rz(c)."""
    b = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    a = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    c = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def matrix_to_euler_zyx(R):
    """Intrinsic ZYX angles of R = Rz(a) Ry(b) Rx(c)."""
    b = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    a = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    c = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([a, b, c], dim=-1)

"""nimblephysics_tpu_torch's single-world step held to the hand-derived
golden values of tests/test_golden_values.py, at that file's
tolerances: the pendulum's accelerations and Jacobians, a box resting,
held by static friction and sliding, a bouncing and an inelastic sphere,
two stacked boxes, a joint limit, a servo, a bounce with friction, and
the mass, COM and inertia gradients.

The worlds are tests/worlds.py's, carried across with dump_world; the
Jacobians are torch.autograd.functional.jacobian where the JAX file takes
jax.jacfwd. Nothing of JAX is run.
"""

import numpy as np
import torch
from torch.autograd.functional import jacobian

from nimblephysics_tpu.simulation import World as JaxWorld

from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.dynamics.skeleton import default_body_params
from nimblephysics_tpu_torch.neural import Engine
from torch_parity import dump_world
from worlds import free_box, free_sphere, ground_plane, pendulum

DT = 1e-3
G = 9.81
F64 = dict(dtype=torch.float64)


def _engine(*skels, gravity=(0, 0, -G), setup=None):
    jw = JaxWorld(time_step=DT, gravity=gravity)
    for s in skels:
        jw.add_skeleton(s)
    if setup is not None:
        setup(jw)
    return Engine(world_from_arrays(dump_world(jw)), device="cpu")


def vec(*x):
    return torch.tensor(x, **F64)


def zeros(n):
    return torch.zeros(n, **F64)


def unit(n, i, value=1.0):
    x = zeros(n)
    x[i] = value
    return x


def _normal_sum(r):
    C = r.contact_depths.shape[0]
    return float(r.impulses[: 3 * C][0::3].sum())


def test_pendulum_hanging_and_horizontal_accel_golden():
    eng = _engine(pendulum())
    r = eng.step(zeros(1), zeros(1), zeros(1))
    np.testing.assert_allclose(float(r.v[0]), 0.0, atol=1e-12)
    r2 = eng.step(vec(np.pi / 2), zeros(1), zeros(1))
    np.testing.assert_allclose(float(r2.v[0]), DT * -(G * 0.5) / (1.0 / 3.0), rtol=1e-10)


def test_pendulum_force_vel_jacobian_golden():
    eng = _engine(pendulum())
    J = jacobian(lambda u: eng.step(vec(0.3), vec(0.2), u).v, zeros(1))
    np.testing.assert_allclose(float(J[0, 0]), DT / (1.0 / 3.0), rtol=1e-10)


def test_pendulum_pos_integration_jacobians_golden():
    eng = _engine(pendulum())
    q0, v0, u0 = vec(0.4), vec(-0.3), vec(0.7)
    Jq = jacobian(lambda q: eng.step(q, v0, u0).q, q0)
    Jv = jacobian(lambda v: eng.step(q0, v, u0).q, v0)
    Ju = jacobian(lambda u: eng.step(q0, v0, u).q, u0)
    np.testing.assert_allclose(Jq.numpy(), [[1.0]], atol=1e-12)
    np.testing.assert_allclose(Jv.numpy(), [[DT]], atol=1e-12)
    np.testing.assert_allclose(Ju.numpy(), [[0.0]], atol=1e-12)


def _resting_box(mu=1.0, mass=1.0):
    eng = _engine(free_box(mass=mass, friction=mu, restitution=0.0),
                  ground_plane(mu=1.0, restitution=1.0))
    return eng, unit(6, 5, 0.1 - 1e-5)


def test_resting_box_normal_impulse_golden():
    eng, q = _resting_box()
    r = eng.step(q, zeros(6), zeros(6))
    np.testing.assert_allclose(r.v.numpy(), 0.0, atol=1e-10)
    np.testing.assert_allclose(r.q.numpy(), q.numpy(), atol=1e-12)
    np.testing.assert_allclose(_normal_sum(r), 1.0 * G * DT, rtol=1e-8)


def test_static_friction_holds_golden():
    eng, q = _resting_box(mu=1.0)
    u = unit(6, 3, 4.0)
    r = eng.step(q, zeros(6), u)
    np.testing.assert_allclose(r.v.numpy(), 0.0, atol=1e-9)
    J = jacobian(lambda uu: eng.step(q, zeros(6), uu).v[3], u)
    np.testing.assert_allclose(float(J[3]), 0.0, atol=1e-8)


def test_slipping_friction_accel_golden():
    mu = 0.5
    eng, q = _resting_box(mu=mu)
    v = unit(6, 3)
    r = eng.step(q, v, zeros(6))
    np.testing.assert_allclose(float(r.v[3]), 1.0 - DT * mu * G, rtol=1e-8)
    J = jacobian(lambda vv: eng.step(q, vv, zeros(6)).v[3], v)
    np.testing.assert_allclose(float(J[3]), 1.0, atol=1e-7)


def test_slipping_force_vel_jacobian_golden():
    eng, q = _resting_box(mu=0.5)
    v = unit(6, 3)
    J = jacobian(lambda u: eng.step(q, v, u).v[3], zeros(6))
    np.testing.assert_allclose(float(J[3]), DT / 1.0, rtol=1e-7)


def test_bounce_velocity_reversal_golden():
    e = 0.6
    eng = _engine(free_sphere(radius=0.1, restitution=e), ground_plane(restitution=1.0))
    q, v_in = unit(6, 5, 0.0999), -2.0
    v = unit(6, 5, v_in)
    r = eng.step(q, v, zeros(6))
    np.testing.assert_allclose(float(r.v[5]), -e * (v_in - G * DT), rtol=1e-9)
    J = jacobian(lambda vv: eng.step(q, vv, zeros(6)).v[5], v)
    np.testing.assert_allclose(float(J[5]), -e, rtol=1e-6)


def test_inelastic_impact_golden():
    eng = _engine(free_sphere(radius=0.1, restitution=0.0), ground_plane(restitution=1.0))
    r = eng.step(unit(6, 5, 0.0999), unit(6, 5, -1.0), zeros(6))
    np.testing.assert_allclose(float(r.v[5]), 0.0, atol=1e-9)
    np.testing.assert_allclose(_normal_sum(r), 1.0 * (1.0 + G * DT), rtol=1e-7)


def test_stacked_boxes_impulse_distribution_golden():
    m1, m2 = 2.0, 1.0
    eng = _engine(free_box(size=(0.3, 0.3, 0.2), mass=m1, friction=1.0),
                  free_box(size=(0.2, 0.2, 0.2), mass=m2, friction=1.0), ground_plane())
    q = zeros(12)
    q[5], q[11] = 0.1 - 1e-5, 0.3 - 2e-5
    r = eng.step(q, zeros(12), zeros(12))
    np.testing.assert_allclose(r.v.numpy(), 0.0, atol=1e-8)
    C = r.contact_depths.shape[0]
    z = r.impulses[: 3 * C].reshape(C, 3).numpy()
    depths = r.contact_depths.numpy()
    np.testing.assert_allclose(z[depths > -1e-12, 0].sum(), ((m1 + m2) + m2) * G * DT,
                               rtol=1e-6)


def test_joint_limit_stop_golden():
    from nimblephysics_tpu.dynamics.skeleton import Skeleton

    sk = Skeleton("limited_pendulum")
    sk.add_joint_and_body(
        "revolute", parent=-1, name="link0", axis=[0.0, 1.0, 0.0],
        T_cj=np.block([[np.eye(3), np.array([[0], [0], [0.5]])],
                       [np.zeros((1, 3)), np.ones((1, 1))]]),
        mass=1.0, inertia=np.eye(3) * (1.0 / 12.0),
        position_lower=[-0.5], position_upper=[0.5],
    )
    eng = _engine(sk, gravity=(0, 0, 0))
    q = vec(0.5 + 1e-6)
    r = eng.step(q, vec(1.0), zeros(1))
    np.testing.assert_allclose(float(r.v[0]), 0.0, atol=2e-5)
    J = jacobian(lambda u: eng.step(q, vec(1.0), u).v, vec(10.0))
    np.testing.assert_allclose(float(J[0, 0]), 0.0, atol=1e-8)
    r2 = eng.step(q, vec(-1.0), zeros(1))
    np.testing.assert_allclose(float(r2.v[0]), -1.0, atol=1e-10)


def test_servo_exact_tracking_golden():
    eng = _engine(pendulum(), setup=lambda w: w.set_actuator_type(0, "servo", force_limit=1e6))
    J = jacobian(lambda c: eng.step(vec(0.7), vec(0.1), c).v, vec(0.5))
    r = eng.step(vec(0.7), vec(0.1), vec(0.5))
    np.testing.assert_allclose(float(r.v[0]), 0.5, atol=1e-9)
    np.testing.assert_allclose(float(J[0, 0]), 1.0, atol=1e-8)


def test_bounce_with_friction_coupling_golden():
    e, mu = 0.5, 0.3
    eng = _engine(free_box(mass=1.0, friction=mu, restitution=e),
                  ground_plane(mu=1.0, restitution=1.0))
    q = unit(6, 5, 0.1 - 1e-5)
    v_z_in, v_x = -2.0, 3.0
    v = zeros(6)
    v[5], v[3] = v_z_in, v_x
    v_z_pre = v_z_in - G * DT
    assert mu * (1 + e) * abs(v_z_pre) < v_x
    r = eng.step(q, v, zeros(6))
    np.testing.assert_allclose(float(r.v[5]), -e * v_z_pre, rtol=1e-8)
    np.testing.assert_allclose(float(r.v[3]), v_x + mu * (1 + e) * v_z_pre, rtol=1e-7)
    np.testing.assert_allclose(float(r.v[1]), 0.0, atol=1e-8)
    Jv = jacobian(lambda vv: eng.step(q, vv, zeros(6)).v, v)
    np.testing.assert_allclose(float(Jv[3, 5]), mu * (1 + e), rtol=1e-6)
    np.testing.assert_allclose(float(Jv[5, 5]), -e, rtol=1e-6)
    np.testing.assert_allclose(float(Jv[3, 3]), 1.0, atol=1e-7)
    np.testing.assert_allclose(float(Jv[5, 3]), 0.0, atol=1e-7)


def _world_params(eng):
    parts = [default_body_params(sk) for sk in eng.world.skeletons]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def test_mass_gradient_through_contact_golden():
    eng, q = _resting_box(mass=2.0)
    bp = _world_params(eng)

    def normal_impulse_sum(m):
        r = eng.step(q, zeros(6), zeros(6), body_params={**bp, "masses": m})
        C = r.contact_depths.shape[0]
        return torch.sum(r.impulses[: 3 * C][0::3])

    m0 = bp["masses"]
    np.testing.assert_allclose(float(normal_impulse_sum(m0)), 2.0 * G * DT, rtol=1e-8)
    np.testing.assert_allclose(float(jacobian(normal_impulse_sum, m0)[0]), G * DT, rtol=1e-6)
    dv_dm = jacobian(lambda m: eng.step(q, zeros(6), zeros(6),
                                        body_params={**bp, "masses": m}).v, m0)
    np.testing.assert_allclose(dv_dm.numpy(), 0.0, atol=1e-7)


def _horizontal_pendulum():
    eng = _engine(pendulum())
    bp = default_body_params(eng.world.skeletons[0])
    q = vec(np.pi / 2)

    def next_v(params):
        return eng.step(q, zeros(1), zeros(1), body_params=params).v[0]

    return bp, next_v


def test_com_gradient_golden():
    bp, next_v = _horizontal_pendulum()
    dv = jacobian(lambda c: next_v({**bp, "coms": c}), bp["coms"])
    np.testing.assert_allclose(float(dv[0, 2]), DT * G * (1.0 / 12.0 - 0.25) / (1.0 / 3.0) ** 2,
                               rtol=1e-9)
    np.testing.assert_allclose(float(dv[0, 1]), 0.0, atol=1e-10)


def test_inertia_gradient_golden():
    bp, next_v = _horizontal_pendulum()
    dv = jacobian(lambda I: next_v({**bp, "inertias": I}), bp["inertias"])
    np.testing.assert_allclose(float(dv[0, 1, 1]), DT * 1.0 * G * 0.5 / (1.0 / 3.0) ** 2,
                               rtol=1e-9)
    np.testing.assert_allclose(float(dv[0, 0, 0]), 0.0, atol=1e-10)


def test_mass_gradient_smooth_golden():
    bp, next_v = _horizontal_pendulum()
    dv = jacobian(lambda m: next_v({**bp, "masses": m}), bp["masses"])
    np.testing.assert_allclose(float(dv[0]), -DT * G * 0.5 * (1.0 / 12.0) / (1.0 / 3.0) ** 2,
                               rtol=1e-9)

"""nimblephysics_tpu_torch's BackpropSnapshot and WithRespectTo
(neural/backprop_snapshot.py, neural/with_respect_to.py) against the JAX
package, float64 on the CPU: tests/test_verify_battery.py's checks, run
on the port.

* The worlds are the battery's nine (its ZOO, carried across with
  dump_world) and a half-cheetah state in shallow contact whose
  cold-started step has live impulses (the battery's own half-cheetah
  state steps with none: its Jacobians are contact-free).
* The JAX side is its jitted forward step and Ridders finite differences
  of it (torch_parity.jax_step_fn), compiled once a world in a module
  fixture: never jax.jacrev / jacfwd of a step, whose compiles take
  10-42 s a world. The port's analytic Jacobians are held against those
  differences at the battery's limits; where a battery check's JAX side is
  an analytic jacfwd (contact geometry, position screws), the port's
  analytic value is held against FD of the JAX forward function.
"""

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.math import finite_difference_jacobian
from nimblephysics_tpu.neural.backprop_snapshot import BackpropSnapshot as JaxSnapshot

from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.neural import (
    ACCELERATION,
    GROUP_COMS,
    GROUP_INERTIAS,
    GROUP_SCALES,
    LINEARIZED_MASSES,
    BackpropSnapshot,
    Engine,
    forward_pass,
    jacobian_wrt,
)
from nimblephysics_tpu_torch.neural.with_respect_to import dims, jacobian_rows
from test_verify_battery import ZOO
from torch_parity import dump_world, jax_step_fn, n, shallow_cheetah_state, t64

CFG = dict(ZOO)
CONTACT = "half_cheetah_contact"
NAMES = [name for name, _ in ZOO] + [CONTACT]
F64 = dict(dtype=torch.float64, device="cpu")
ROW_WORLDS = ["box_static_friction", "box_slipping", "sphere_bouncing", "sphere_stack",
              "half_cheetah", CONTACT]


class Case(NamedTuple):
    jw: object  # the JAX world
    tw: object  # the port's world
    q: np.ndarray
    v: np.ndarray
    u: np.ndarray
    f: Callable  # the JAX forward step, jitted: f(q, v, u, bp) -> [q'; v']
    snap: BackpropSnapshot  # the port's, on the CPU


def _make(name):
    if name == CONTACT:
        jw, _, q, v, u = shallow_cheetah_state()
    else:
        jw, q, v, u = CFG[name]()
    jw.set_action_space(list(range(jw.num_dofs)))
    tw = world_from_arrays(dump_world(jw))
    snap = forward_pass(tw, t64(np.concatenate([q, v])), t64(u))
    return Case(jw, tw, q, v, u, jax_step_fn(jw), snap)


@pytest.fixture(scope="module")
def cases():
    store = {}

    def get(name):
        if name not in store:
            store[name] = _make(name)
        return store[name]

    return get


def _fd(f, x0):
    return finite_difference_jacobian(f, np.asarray(x0, np.float64))


def _close(got, want, tol):
    np.testing.assert_allclose(n(got), want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# The state and force-vel Jacobians, backprop (battery :167-227)
# ---------------------------------------------------------------------------


def test_the_contact_state_has_live_impulses(cases):
    """The shallow half-cheetah state steps with live impulses, cold-started
    as the snapshot steps, on both sides."""
    c = cases(CONTACT)
    z = n(c.snap.result.impulses)
    assert np.abs(z).max() > 1e-2 and (np.abs(z) > 0).sum() >= 4
    assert float(c.snap.result.contact_depths.max()) > 0
    nv = c.tw.num_dofs
    want = c.f(c.q, c.v, c.u)
    np.testing.assert_allclose(np.concatenate([n(c.snap.q_next), n(c.snap.v_next)]), want,
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_state_jacobian_matches_jax_fd(cases, name):
    c = cases(name)
    nv = c.tw.num_dofs
    J_fd = _fd(lambda x: c.f(x[:nv], x[nv:], c.u), np.concatenate([c.q, c.v]))
    _close(c.snap.get_state_jacobian(), J_fd, 2e-6)


@pytest.mark.parametrize("name", ROW_WORLDS)
def test_state_jacobian_matches_its_own_fd(cases, name):
    """On the worlds with constraint rows, also against the port's own
    Ridders FD (finite_difference_state_jacobian)."""
    c = cases(name)
    assert c.snap.engine.num_constraint_rows > 0
    _close(c.snap.get_state_jacobian(), c.snap.finite_difference_state_jacobian(), 2e-6)


@pytest.mark.parametrize("name", NAMES)
def test_force_vel_jacobian_matches_jax_fd(cases, name):
    c = cases(name)
    nv = c.tw.num_dofs
    J_fd = _fd(lambda x: c.f(c.q, c.v, x)[nv:], c.u)
    _close(c.snap.get_force_vel_jacobian(), J_fd, 2e-6)


@pytest.mark.parametrize("name", NAMES)
def test_backprop_state_matches_jacobian_and_jax_fd(cases, name):
    c = cases(name)
    nv = c.tw.num_dofs
    g = np.random.RandomState(0).randn(2 * nv)
    loss_wrt_state, loss_wrt_action, loss_wrt_mass = c.snap.backprop_state(t64(g))
    assert loss_wrt_mass is None
    J = n(c.snap.get_state_jacobian())
    _close(loss_wrt_state, J.T @ g, 1e-8)
    _close(loss_wrt_action, n(c.snap.get_action_jacobian()).T @ g, 1e-8)
    grad_fd = _fd(lambda x: (c.f(x[:nv], x[nv:], c.u) @ g)[None],
                  np.concatenate([c.q, c.v]))[0]
    _close(loss_wrt_state, grad_fd, 5e-6)


def test_jacobian_blocks_are_cached_and_detached(cases):
    """Every block comes from the state and force Jacobians of one batched
    reverse pass, is cached, and holds no graph."""
    c = cases("double_pendulum")
    s = c.snap
    nv = c.tw.num_dofs
    J = s.get_state_jacobian()
    assert s.get_state_jacobian() is J
    blocks = {"get_pos_pos_jacobian": J[:nv, :nv], "get_pos_vel_jacobian": J[nv:, :nv],
              "get_vel_pos_jacobian": J[:nv, nv:], "get_vel_vel_jacobian": J[nv:, nv:]}
    for name, want in blocks.items():
        assert torch.equal(getattr(s, name)(), want), name
    Ju = torch.cat([s.get_force_pos_jacobian(), s.get_force_vel_jacobian()])
    assert torch.equal(s.get_action_jacobian(), Ju)
    assert not any(x.requires_grad for x in s._cache.values())
    times = s.benchmark_jacobians(samples=1)
    assert set(times) == {"pos-pos", "pos-vel", "vel-pos", "vel-vel", "force-vel", "state",
                          "action"}
    assert all(t > 0 for t in times.values())


# ---------------------------------------------------------------------------
# Masses, scales and the body-parameter groups (battery :454-480)
# ---------------------------------------------------------------------------


def _masses(jw):
    return np.concatenate([[b.mass for b in s.bodies] for s in jw.skeletons])


@pytest.mark.parametrize("name", ["double_pendulum", "box_slipping", "half_cheetah", CONTACT])
def test_mass_vel_jacobian_matches_jax_fd(cases, name):
    c = cases(name)
    nv = c.tw.num_dofs
    m0 = _masses(c.jw)
    snap = forward_pass(c.tw, t64(np.concatenate([c.q, c.v])), t64(c.u), masses=t64(m0))
    J_fd = _fd(lambda m: c.f(c.q, c.v, c.u, {"masses": m})[nv:], m0)
    _close(snap.get_mass_vel_jacobian(), J_fd, 5e-6)
    g = np.random.RandomState(1).randn(2 * nv)
    _, _, loss_wrt_mass = snap.backprop_state(t64(g))
    J_m = torch.cat([snap._jac("masspos"), snap.get_mass_vel_jacobian()])
    _close(loss_wrt_mass, n(J_m).T @ g, 1e-8)


def _default_bp(jw):
    from nimblephysics_tpu.dynamics.skeleton import default_body_params

    parts = [default_body_params(s) for s in jw.skeletons]
    return {k: np.concatenate([np.asarray(p[k]) for p in parts])
            for k in ("masses", "coms", "inertias")}


def _jax_group(wrt, bp, nb):
    """(theta0, theta -> JAX body_params) of one body-parameter group, the
    JAX jacobian_wrt's reparametrisations (with_respect_to.py:99-131)."""
    if wrt is GROUP_COMS:
        return bp["coms"].ravel(), lambda t: {**bp, "coms": t.reshape(nb, 3)}
    if wrt is GROUP_INERTIAS:
        return bp["inertias"].ravel(), lambda t: {**bp, "inertias": t.reshape(nb, 3, 3)}
    if wrt is GROUP_SCALES:
        return np.ones(3 * nb), lambda t: {**bp, "scales": t.reshape(nb, 3)}
    m, c = bp["masses"], bp["coms"]

    def linearized(t):
        t = t.reshape(nb, 4)
        mm = t[:, 0]
        return {**bp, "masses": mm, "coms": t[:, 1:] / np.maximum(mm[:, None], 1e-12)}

    return np.concatenate([m[:, None], m[:, None] * c], axis=1).ravel(), linearized


@pytest.mark.parametrize("name", ["box_slipping", "double_pendulum"])
@pytest.mark.parametrize("wrt", [GROUP_COMS, GROUP_INERTIAS, GROUP_SCALES, LINEARIZED_MASSES],
                         ids=lambda w: w.name)
def test_jacobian_wrt_body_groups_matches_jax_fd(cases, name, wrt):
    """jacobian_wrt in the group variables (from the spec's body parameters)
    against JAX FD of the same reparametrisation; tolerance 5e-6, the
    battery's mass limit. With GROUP_SCALES, the snapshot's scale
    Jacobians (masses at the spec's, scales 1: the same step) equal its
    rows."""
    c = cases(name)
    nv, nb = c.tw.num_dofs, c.tw.num_bodies
    eng = Engine(c.tw, device="cpu")

    def f(q, v, u, bp):
        r = eng.step(q, v, u, body_params=bp)
        return torch.cat([r.q, r.v])

    J = jacobian_wrt(c.tw, f, wrt, t64(c.q), t64(c.v), t64(c.u))
    assert J.shape == (2 * nv, dims(c.tw, wrt))
    theta0, bp_of = _jax_group(wrt, _default_bp(c.jw), nb)
    J_fd = _fd(lambda t: c.f(c.q, c.v, c.u, bp_of(jnp.asarray(t))), theta0)
    _close(J, J_fd, 5e-6)
    if wrt is GROUP_SCALES:
        snap = forward_pass(c.tw, t64(np.concatenate([c.q, c.v])), t64(c.u),
                            masses=t64(_masses(c.jw)), scales=torch.ones(nb, 3, **F64))
        Js = J.reshape(2 * nv, nb, 3)
        _close(snap.get_scale_pos_jacobian(), n(Js[:nv]), 1e-10)
        _close(snap.get_scale_vel_jacobian(), n(Js[nv:]), 1e-10)



def test_body_parameter_errors():
    """The JAX errors: mass and scale Jacobians of a snapshot without
    masses or scales, and ACCELERATION in jacobian_wrt."""
    jw, q, v, u = CFG["double_pendulum"]()
    tw = world_from_arrays(dump_world(jw))
    snap = forward_pass(tw, t64(np.concatenate([q, v])), t64(u))
    with pytest.raises(ValueError, match="masses="):
        snap.get_mass_vel_jacobian()
    for get in (snap.get_scale_vel_jacobian, snap.get_scale_pos_jacobian):
        with pytest.raises(ValueError, match="scales="):
            get()
    with pytest.raises(NotImplementedError):
        jacobian_wrt(tw, lambda *a: a[0], ACCELERATION, t64(q), t64(v), t64(u))


# ---------------------------------------------------------------------------
# The action space
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,action", [("double_pendulum", [1]),
                                         (CONTACT, [3, 4, 5, 6, 7, 8])])
def test_action_jacobian_on_a_partial_action_space(cases, name, action):
    """get_action_jacobian and backprop_state's loss_wrt_action with an
    action space of some dofs: against JAX FD in the action (the control
    scattered from it), from forward_pass's action and from a snapshot
    whose control also drives dofs outside the action space (differentiated,
    as the JAX snapshot does, at that control's action)."""
    c = cases(name)
    nv = c.tw.num_dofs
    tw = world_from_arrays(dump_world(c.jw))
    tw.set_action_space(action)
    idx = np.asarray(action)

    def scatter(a):
        u = np.zeros(nv)
        u[idx] = a
        return u

    a0 = c.u[idx]
    J_fd = _fd(lambda a: c.f(c.q, c.v, scatter(a)), a0)
    x = t64(np.concatenate([c.q, c.v]))
    snap = forward_pass(tw, x, t64(a0))
    _close(snap.get_action_jacobian(), J_fd, 2e-6)
    g = np.random.RandomState(2).randn(2 * nv)
    _, loss_wrt_action, _ = snap.backprop_state(t64(g))
    _close(loss_wrt_action, n(snap.get_action_jacobian()).T @ g, 1e-8)
    full = BackpropSnapshot(tw, x[:nv], x[nv:], t64(c.u))
    _close(full.get_action_jacobian(), J_fd, 2e-6)


# ---------------------------------------------------------------------------
# The battery's LCP, geometry and kinematics checks (:234-492) on the port
# ---------------------------------------------------------------------------


def _lcp(c):
    """(engine, step result, F, b, mu) of the port's step at the case's
    state: F = J L^-T, as the battery's _lcp_internals rebuilds them."""
    eng = Engine(c.tw, device="cpu")
    args = (t64(c.q), t64(c.v), t64(c.u))
    prob = eng.lcp_problem(*args)
    return eng, eng.step(*args), n(prob.F), n(prob.b), n(prob.mu)


@pytest.mark.parametrize("name", ROW_WORLDS)
def test_f_c_kkt(cases, name):
    """The impulses satisfy the boxed LCP's KKT conditions (verifyF_c)."""
    eng, r, F, b, mu = _lcp(cases(name))
    z = n(r.impulses)
    meta = eng.assembler.meta
    w = F @ (F.T @ z) - b  # A z - b
    fidx = np.maximum(meta.findex, 0)
    tol = 1e-6 * (1.0 + np.abs(b).max())
    lo = meta.lo_const if meta.lo_const is not None else np.zeros(meta.n)
    hi = meta.hi_const if meta.hi_const is not None else np.full(meta.n, np.inf)
    for i in range(meta.n):
        if meta.is_friction[i]:
            bound = mu[i] * z[fidx[i]]
            assert abs(z[i]) <= bound + tol, f"friction row {i} outside cone"
            if abs(z[i]) < bound - tol:  # strictly inside -> w = 0
                assert abs(w[i]) < 20 * tol, f"friction row {i}: w={w[i]}"
        else:
            assert lo[i] - tol <= z[i] <= hi[i] + tol
            if lo[i] + tol < z[i] < hi[i] - tol:
                assert abs(w[i]) < 20 * tol, f"row {i}: w={w[i]}"
            elif z[i] <= lo[i] + tol and np.isfinite(lo[i]):
                assert w[i] > -20 * tol, f"row {i}: w={w[i]} at lower bound"


@pytest.mark.parametrize("name", ["box_static_friction", "sphere_stack", "half_cheetah",
                                  CONTACT])
def test_next_v(cases, name):
    """v' = v_pre + M^-1 J^T z, with M from the port's mass_matrix
    (verifyNextV)."""
    from nimblephysics_tpu_torch.dynamics.skeleton import mass_matrix

    c = cases(name)
    _, r, F, _, _ = _lcp(c)
    u_vec = F.T @ n(r.impulses)
    dv = np.zeros(c.tw.num_dofs)
    for skel, (s, e) in zip(c.tw.skeletons, c.tw.dof_slices()):
        if skel.num_dofs:
            L = np.linalg.cholesky(n(mass_matrix(skel, t64(c.q[s:e]))))
            dv[s:e] = np.linalg.solve(L.T, u_vec[s:e])
    np.testing.assert_allclose(n(r.v), n(r.v_pre) + dv, atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("name", ["box_static_friction", "sphere_stack", "half_cheetah",
                                  CONTACT])
def test_perturbed_contact_geometry(cases, name):
    """The contact points, normals and depths: the port's autograd Jacobian
    in q against Ridders FD of the JAX collider, 5e-7."""
    from nimblephysics_tpu.neural.timestep import Engine as JaxEngine

    c = cases(name)
    jeng = JaxEngine(c.jw)

    @jax.jit
    def geom_jax(qq):
        k = jeng.collider.collide(qq)
        return jnp.concatenate([k.point.ravel(), k.normal.ravel(), k.depth.ravel()])

    col = Engine(c.tw, device="cpu").collider
    qt = t64(c.q).requires_grad_()
    k = col.collide(qt)
    out = torch.cat([k.point.reshape(-1), k.normal.reshape(-1), k.depth.reshape(-1)])
    J = jacobian_rows(out, [qt])[0]
    np.testing.assert_allclose(n(out), np.asarray(geom_jax(c.q)), atol=1e-12)
    _close(J, _fd(lambda x: np.asarray(geom_jax(x)), c.q), 5e-7)


@pytest.mark.parametrize("name", NAMES[:-1])
def test_joint_position_jacobians(cases, name):
    """Each body origin's point Jacobian from the port's J_world against
    Ridders FD of the JAX forward kinematics, 1e-7."""
    from nimblephysics_tpu.dynamics.skeleton import full_kinematics as jax_kin

    from nimblephysics_tpu_torch.dynamics.skeleton import full_kinematics

    c = cases(name)
    for jskel, skel, (s, e) in zip(c.jw.skeletons, c.tw.skeletons, c.tw.dof_slices()):
        if skel.num_dofs == 0:
            continue
        positions = jax.jit(lambda qq, sk=jskel: jax_kin(sk, qq)["T_wb"][:, :3, 3].ravel())
        J_fd = _fd(lambda x: np.asarray(positions(x)), c.q[s:e])
        kin = full_kinematics(skel, t64(c.q[s:e]))
        Jw, T = n(kin["J_world"]), n(kin["T_wb"])
        J_an = np.concatenate([Jw[b, 3:] - _skew(T[b, :3, 3]) @ Jw[b, :3]
                               for b in range(Jw.shape[0])])
        np.testing.assert_allclose(J_an, J_fd, atol=1e-7, rtol=1e-7)


def _skew(p):
    return np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])


@pytest.mark.parametrize("name", NAMES[:-1])
def test_position_screws(cases, name):
    """d/dh integrate(q, v, h) at h = 0 by the port's autograd against the
    JAX integrator's difference slope (h = 1e-6), 1e-5; integrate(q, v, 0)
    is q (verifyPositionScrews)."""
    from nimblephysics_tpu.simulation.world import world_integrate_positions as jax_integ

    from nimblephysics_tpu_torch.simulation.world import world_integrate_positions

    c = cases(name)
    integ = jax.jit(lambda h: jax_integ(c.jw, jnp.asarray(c.q), jnp.asarray(c.v), h))
    h = 1e-6
    slope = (np.asarray(integ(h)) - np.asarray(integ(0.0))) / h
    ht = torch.zeros((), **F64).requires_grad_()
    out = world_integrate_positions(c.tw, t64(c.q), t64(c.v), ht)
    d_ad = jacobian_rows(out, [ht])[0]
    np.testing.assert_allclose(n(d_ad), slope, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(n(out), c.q, atol=1e-12)


@pytest.mark.parametrize("name", ["box_static_friction", "box_slipping", "sphere_stack"])
def test_translational_lcp_invariance(cases, name):
    """Translating every free body along x leaves the impulses and v' as
    they were (verifyTranlationalLCPInvariance)."""
    c = cases(name)
    eng = Engine(c.tw, device="cpu")
    r0 = eng.step(t64(c.q), t64(c.v), t64(c.u))
    q2 = c.q.copy()
    for skel, (s, e) in zip(c.tw.skeletons, c.tw.dof_slices()):
        if skel.num_dofs == 6:
            q2[s + 3] += 0.37
    r1 = eng.step(t64(q2), t64(c.v), t64(c.u))
    assert float(r0.impulses.abs().max()) > 0
    np.testing.assert_allclose(n(r0.impulses), n(r1.impulses), atol=1e-8)
    np.testing.assert_allclose(n(r0.v), n(r1.v), atol=1e-8)


def test_no_multistep_interference(cases):
    """Steps are pure: unrelated steps on the same engine, and a snapshot's
    Jacobians and backprop in between, leave a step's result as it was."""
    c = cases("box_slipping")
    eng = Engine(c.tw, device="cpu")
    args = (t64(c.q), t64(c.v), t64(c.u))
    r0 = eng.step(*args)
    for _ in range(3):
        eng.step(args[0] + 0.1, args[1] - 0.2, args[2])
    c.snap.get_state_jacobian()
    c.snap.backprop(torch.ones(6, **F64), torch.ones(6, **F64))
    r1 = eng.step(*args)
    assert torch.equal(r0.q, r1.q) and torch.equal(r0.v, r1.v)
    assert torch.equal(c.snap.q_next, r1.q) and torch.equal(c.snap.v_next, r1.v)


# ---------------------------------------------------------------------------
# Debug modes and the loss-gradient clip
# ---------------------------------------------------------------------------


def test_gradient_debug_modes():
    """World.use_fd_override makes get_state_jacobian the FD Jacobian;
    slow_debug_results_against_fd passes at the default tolerance and
    raises with a repro at a tolerance of 0."""
    jw, q, v, u = CFG["pendulum_swing"]()
    tw = world_from_arrays(dump_world(jw))
    assert (tw.use_fd_override, tw.slow_debug_results_against_fd,
            tw.fd_debug_tolerance) == (False, False, 1e-5)
    x = t64(np.concatenate([q, v]))
    snap = forward_pass(tw, x, t64(u))
    fd = snap.finite_difference_state_jacobian()
    tw.use_fd_override = True
    np.testing.assert_array_equal(n(snap.get_state_jacobian()), fd)
    tw.use_fd_override = False
    tw.slow_debug_results_against_fd = True
    J = snap.get_state_jacobian()
    _close(J, fd, 1e-5)
    tw.fd_debug_tolerance = 0.0
    with pytest.raises(AssertionError, match="Repro:"):
        snap.get_state_jacobian()


def test_clip_loss_gradients_to_bounds():
    """A half-cheetah state with joints at their position limits and
    velocities at theirs: the port's clip against the JAX _clip_to_bounds
    (numpy in, numpy out), and a clipping snapshot's backprop is the clip
    of the plain one's."""
    from nimblephysics_tpu.models import half_cheetah

    jw, q0, _ = half_cheetah()
    jw.set_action_space(list(range(jw.num_dofs)))
    for skel in jw.skeletons:  # the model sets no velocity limit
        skel.joints = [dataclasses.replace(j, velocity_limit=np.full(j.num_dofs, 4.0))
                       for j in skel.joints]
    tw = world_from_arrays(dump_world(jw))
    nv = tw.num_dofs
    lo, hi, vlim = (tw.position_lower_limits(), tw.position_upper_limits(),
                    tw.velocity_limits())
    assert np.isfinite(lo[3:]).all() and np.array_equal(vlim, jw.velocity_limits())
    q = np.asarray(q0, np.float64).copy()
    q[3::2], q[4::2] = lo[3::2], hi[4::2]
    v = np.zeros(nv)
    v[0::2], v[1::2] = vlim[0::2], -vlim[1::2]
    rng = np.random.RandomState(3)
    gq, gv = rng.randn(nv), rng.randn(nv)
    ref = JaxSnapshot.__new__(JaxSnapshot)
    ref.world, ref.q, ref.v = jw, jnp.asarray(q), jnp.asarray(v)
    want = [np.asarray(x) for x in ref._clip_to_bounds(jnp.asarray(gq), jnp.asarray(gv))]
    x = t64(np.concatenate([q, v]))
    snap = forward_pass(tw, x, torch.zeros(nv, **F64), clip_loss_gradients_to_bounds=True)
    got = snap._clip_to_bounds(t64(gq), t64(gv))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), b)
    assert (want[0] == 0).any() and (want[1] == 0).any() and (want[0] != gq).sum() < nv
    plain = forward_pass(tw, x, torch.zeros(nv, **F64)).backprop(t64(gq), t64(gv))
    clipped = snap.backprop(t64(gq), t64(gv))
    for a, b in zip(snap._clip_to_bounds(plain.loss_wrt_position, plain.loss_wrt_velocity),
                    clipped[:2]):
        assert torch.equal(a, b)
    assert torch.equal(plain.loss_wrt_torque, clipped.loss_wrt_torque)


# ---------------------------------------------------------------------------
# The Jacobian's batched reverse pass, and chip_smoke.py's world
# ---------------------------------------------------------------------------


def test_seed_clip_is_torch_max_min_and_batches_in_the_backward():
    """lcp_cuda.clip, the seed's projection: the values and gradients of
    torch.minimum(torch.maximum(x, lo), hi), ties (which split the gradient
    in halves) and infinite bounds included, bit for bit; its backward
    vmapped over a Jacobian's rows takes no per-row fallback (torch's
    max/min backward does: an aten::stack of the rows' results)."""
    from nimblephysics_tpu_torch.batched.lcp_cuda import clip

    x0 = t64([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 3.0])
    lo0 = t64([-1.0, -1.0, -1.0, 0.0, -np.inf, -1.0, 2.0, -1.0])
    hi0 = t64([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0, np.inf])
    eye = torch.eye(8, **F64)

    def rows(f):
        x, lo, hi = (t.clone().requires_grad_() for t in (x0, lo0, hi0))
        out = f(x, lo, hi)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            J = torch.autograd.grad(out, (x, lo, hi), eye, is_grads_batched=True)
        stacks = sum(e.name == "aten::stack" for e in prof.events())
        return out.detach(), J, stacks

    want, J_want, stacks_torch = rows(lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi))
    got, J_got, stacks = rows(clip)
    assert torch.equal(got, want)
    for a, b in zip(J_got, J_want):
        assert torch.equal(a, b)
    assert (J_want[0].diagonal() == 0.5).sum() >= 2  # the ties are exercised
    assert stacks == 0 and stacks_torch > 0


def test_chip_smoke_sphere_stack_is_the_battery_world(cases):
    """chip_smoke.py's phase 21 builds the battery's sphere_stack with the
    port's own Skeleton API (it imports nothing of the JAX package): the same
    step at the battery's state."""
    import chip_smoke

    c = cases("sphere_stack")
    world, state, u = chip_smoke.sphere_stack()
    np.testing.assert_array_equal(state, np.concatenate([c.q, c.v]))
    np.testing.assert_array_equal(u, c.u)
    snap = forward_pass(world, t64(state), t64(u))
    assert torch.equal(snap.q_next, c.snap.q_next) and torch.equal(snap.v_next, c.snap.v_next)
    assert torch.equal(snap.result.impulses, c.snap.result.impulses)

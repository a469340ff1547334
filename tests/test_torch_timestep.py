"""nimblephysics_tpu_torch's single-world step (neural/timestep.py) against
the JAX package's, float64 on the CPU.

* Function by function: the kinematics and dynamics of one skeleton,
  every primitive narrowphase pair, the assembled rows and boxed_lcp with
  its VJP, each JAX function under one jax.jit.
* Engine.step against the JAX Engine.step over four warm-started steps,
  and its VJP in (q, v, control, masses) against jax.vjp.
* The single-world Engine against the port's own BatchedEngine at B = 4
  (tests/test_batched.py's cases and levels), with no JAX compiled.

Inputs are made with numpy from a seed; worlds come from tests/worlds.py
and nimblephysics_tpu.models and cross over with dump_world. The JAX
engine is never compiled on the half-cheetah's gradient (15 s) or on a
box stack.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.collision import narrowphase as jnp_np
from nimblephysics_tpu.constraint import assembly as jasm
from nimblephysics_tpu.dynamics import joints as jnt
from nimblephysics_tpu.dynamics import skeleton as jsk
from nimblephysics_tpu.math import lie as jlie
from nimblephysics_tpu.neural.timestep import Engine as JaxEngine
from nimblephysics_tpu.simulation import World as JaxWorld

from nimblephysics_tpu_torch.batched import BatchedEngine
from nimblephysics_tpu_torch.collision import narrowphase as tnp
from nimblephysics_tpu_torch.constraint import lcp as tlcp
from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.dynamics import joints as tjn
from nimblephysics_tpu_torch.dynamics import skeleton as tsk
from nimblephysics_tpu_torch.math import lie as tlie
from nimblephysics_tpu_torch.neural import Engine, timestep
from torch_parity import dump_world, t64
import worlds as W

F64 = dict(device="cpu", dtype=torch.float64)


def _pair(*skels, gravity=(0.0, 0.0, -9.81), dt=1e-3, solver=None):
    """(JAX world, port world) holding the given JAX skeletons."""
    jw = JaxWorld(time_step=dt, gravity=gravity)
    for s in skels:
        jw.add_skeleton(s)
    if solver is not None:
        jw.solver = solver
    return jw, world_from_arrays(dump_world(jw))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# The Lie maps
# ---------------------------------------------------------------------------


def test_lie_maps_match_jax():
    rng = np.random.RandomState(0)
    w = np.concatenate([rng.randn(6, 3), 1e-9 * rng.randn(2, 3),
                        (np.pi - 1e-3) * np.eye(3)[:2]])
    dw = rng.randn(*w.shape)
    xi = rng.randn(5, 6)
    ang = rng.uniform(-1.2, 1.2, (5, 3))

    def jax_side(w, dw, xi, ang):
        R = jlie.exp_map_rot(w)
        T = jlie.exp_map(xi)
        return dict(
            R=R, log=jax.vmap(jlie.log_map_rot)(R), Jl=jlie.so3_left_jacobian(w),
            Jr=jlie.so3_right_jacobian(w), Jli=jlie.so3_left_jacobian_inv(w),
            Jri=jlie.so3_right_jacobian_inv(w),
            dJr=jax.vmap(jlie.so3_right_jacobian_time_deriv)(w, dw),
            dJl=jax.vmap(jlie.so3_left_jacobian_time_deriv)(w, dw),
            T=T, logT=jax.vmap(jlie.log_map)(T), Ad=jlie.Ad(T), Adi=jlie.Ad_inv(T),
            ad=jlie.ad(xi), ada=jlie.ad_apply(xi, xi[::-1]),
            dada=jlie.dad_apply(xi, xi[::-1]),
            E=jlie.euler_to_matrix(ang, "zyx"),
            exyz=jlie.matrix_to_euler_xyz(jlie.euler_to_matrix(ang, "xyz")),
            ezyx=jlie.matrix_to_euler_zyx(jlie.euler_to_matrix(ang, "zyx")),
            dAd=jlie.dAd(T), Tinv=jlie.transform_inv(T), unskew=jlie.unskew(R),
            tp=jlie.transform_point(T, xi[:, 3:]), tv=jlie.transform_vector(T, xi[:, :3]),
        )

    want = jax.jit(jax_side)(w, dw, xi, ang)
    tw, tdw, txi, tang = (t64(x) for x in (w, dw, xi, ang))
    R = tlie.exp_map_rot(tw)
    T = tlie.exp_map(txi)
    got = dict(
        R=R, log=tlie.log_map_rot(R), Jl=tlie.so3_left_jacobian(tw),
        Jr=tlie.so3_right_jacobian(tw), Jli=tlie.so3_left_jacobian_inv(tw),
        Jri=tlie.so3_right_jacobian_inv(tw),
        dJr=tlie.so3_right_jacobian_time_deriv(tw, tdw),
        dJl=tlie.so3_left_jacobian_time_deriv(tw, tdw),
        T=T, logT=tlie.log_map(T), Ad=tlie.Ad(T), Adi=tlie.Ad_inv(T),
        ad=tlie.ad(txi), ada=tlie.ad_apply(txi, txi.flip(0)),
        dada=tlie.dad_apply(txi, txi.flip(0)),
        E=tlie.euler_to_matrix(tang, "zyx"),
        exyz=tlie.matrix_to_euler_xyz(tlie.euler_to_matrix(tang, "xyz")),
        ezyx=tlie.matrix_to_euler_zyx(tlie.euler_to_matrix(tang, "zyx")),
        dAd=tlie.dAd(T), Tinv=tlie.transform_inv(T), unskew=tlie.unskew(R),
        tp=tlie.transform_point(T, txi[:, 3:]), tv=tlie.transform_vector(T, txi[:, :3]),
    )
    for k in want:
        close(got[k], want[k], atol=1e-10, rtol=1e-10)
    # The second derivative, by forward-mode differentiation on both sides.
    dd = tlie.so3_right_jacobian_time_deriv_deriv(tw[0], tdw[0], 1)
    close(dd, jlie.so3_right_jacobian_time_deriv_deriv(w[0], dw[0], 1), atol=1e-10)


def test_spatial_inertias_match_jax():
    from nimblephysics_tpu.math import spatial as jsp

    from nimblephysics_tpu_torch.math import spatial as tsp

    pairs = [
        (tsp.spatial_inertia_matrix(1.3, t64([0.1, -0.2, 0.3]), t64(np.diag([0.2, 0.3, 0.4]))),
         jsp.spatial_inertia_matrix(1.3, jnp.array([0.1, -0.2, 0.3]), jnp.diag(jnp.array([0.2, 0.3, 0.4])))),
        (tsp.inertia_box(2.0, [0.1, 0.2, 0.3]), jsp.inertia_box(2.0, jnp.array([0.1, 0.2, 0.3]))),
        (tsp.inertia_sphere(2.0, 0.3), jsp.inertia_sphere(2.0, 0.3)),
        (tsp.inertia_ellipsoid(2.0, [0.1, 0.2, 0.3]), jsp.inertia_ellipsoid(2.0, jnp.array([0.1, 0.2, 0.3]))),
        (tsp.inertia_cylinder(2.0, 0.1, 0.5), jsp.inertia_cylinder(2.0, 0.1, 0.5)),
        (tsp.inertia_capsule(2.0, 0.1, 0.5), jsp.inertia_capsule(2.0, 0.1, 0.5)),
    ]
    for got, want in pairs:
        close(got, want, atol=1e-14, rtol=1e-14)


# ---------------------------------------------------------------------------
# The dynamics of one skeleton
# ---------------------------------------------------------------------------

SKELETONS = {
    "pendulum": W.pendulum,
    "double_pendulum": W.double_pendulum,
    "ball_chain": W.ball_chain,
    "free_box": W.free_box,
    "free_sphere": W.free_sphere,
}


def _body_params(rng, nb):
    return {
        "masses": 1.0 + 0.2 * rng.rand(nb),
        "coms": 0.05 * rng.randn(nb, 3),
        "inertias": np.stack([np.diag(0.05 + 0.1 * rng.rand(3)) for _ in range(nb)]),
        "scales": 1.0 + 0.1 * rng.randn(nb, 3),
    }


@pytest.mark.parametrize("name", SKELETONS)
def test_skeleton_functions_match_jax(name):
    """full_kinematics, mass_and_bias_fused (M and bias), inverse_dynamics
    with external wrenches, point_jacobian and integrate_positions, with
    and without body parameters; forward_kinematics, com_world,
    forward_dynamics, relative_transform with scales, and the last joint's
    Q, S and S-dot: to 1e-10."""
    jw, tw = _pair(SKELETONS[name]())
    js, ts = jw.skeletons[0], tw.skeletons[0]
    rng = np.random.RandomState(1)
    nv, nb = js.num_dofs, js.num_bodies
    q, v, a = (0.7 * rng.randn(nv) for _ in range(3))
    fext = rng.randn(nb, 6)
    pt = rng.randn(3)
    bp = _body_params(rng, nb)
    g = np.array([0.3, -0.2, -9.81])

    def jax_side(q, v, a, fext, pt, bp):
        kin = jsk.full_kinematics(js, q, v, scales=bp["scales"])
        M, C, _ = jsk.mass_and_bias_fused(js, q, v, gravity=g, body_params=bp)
        tau = jsk.inverse_dynamics(js, q, v, a, f_ext_body=fext, gravity=g, body_params=bp)
        return ((kin["T_wb"], kin["J_world"], kin["V"], M, C, tau),
                jsk.point_jacobian(kin["J_world"][-1], pt),
                jsk.integrate_positions(js, q, v, 0.01))

    def jax_rest(q, v, a):
        j = js.joints[-1]
        qj, vj = q[j.q_index:j.q_index + j.num_dofs], v[j.q_index:j.q_index + j.num_dofs]
        s = bp["scales"]
        return (jsk.forward_kinematics(js, q), jsk.com_world(js, q),
                jsk.forward_dynamics(js, q, v, a, gravity=g),
                jsk.relative_transform(j, qj, s_parent=s[j.parent] if j.parent >= 0 else None,
                                       s_child=s[-1]),
                jnt.joint_transform(j, qj), jnt.joint_body_jacobian(j, qj),
                jnt.joint_body_jacobian_dot(j, qj, vj))

    f = jax.jit(jax_side)
    nominal = dict(jsk.default_body_params(js), scales=np.ones((nb, 3)))
    tq, tv, ta, tf, tpt = (t64(x) for x in (q, v, a, fext, pt))
    # The port without body parameters against the JAX functions at the
    # nominal ones, and both under jittered ones.
    for params, jax_params in ((None, nominal), ({k: t64(x) for k, x in bp.items()}, bp)):
        want, pj, qn = f(q, v, a, fext, pt, jax_params)
        sc = None if params is None else params["scales"]
        kin = tsk.full_kinematics(ts, tq, tv, scales=sc)
        M, C, kin2 = tsk.mass_and_bias_fused(ts, tq, tv, gravity=g, body_params=params)
        tau = tsk.inverse_dynamics(ts, tq, tv, ta, f_ext_body=tf, gravity=g,
                                   body_params=params)
        got = (kin["T_wb"], kin["J_world"], kin["V"], M, C, tau)
        for x, y in zip(got, want):
            close(x, y, atol=1e-10, rtol=1e-10)
        close(kin2["J_world"], want[1], atol=1e-10)
        close(tsk.point_jacobian(kin["J_world"][-1], tpt), pj, atol=1e-10)
    close(tsk.integrate_positions(ts, tq, tv, 0.01), qn, atol=1e-10)
    # forward_kinematics, com_world, forward_dynamics, relative_transform
    # and the last joint's Q, S and S-dot.
    j = ts.joints[-1]
    qj, vj = tq[j.q_index:j.q_index + j.num_dofs], tv[j.q_index:j.q_index + j.num_dofs]
    s = t64(bp["scales"])
    got = (tsk.forward_kinematics(ts, tq), tsk.com_world(ts, tq),
           tsk.forward_dynamics(ts, tq, tv, ta, gravity=g),
           tsk.relative_transform(j, qj, s_parent=s[j.parent] if j.parent >= 0 else None,
                                  s_child=s[-1]),
           tjn.joint_transform(j, qj), tjn.joint_body_jacobian(j, qj),
           tjn.joint_body_jacobian_dot(j, qj, vj))
    for x, y in zip(got, jax.jit(jax_rest)(q, v, a)):
        close(x, y, atol=1e-10, rtol=1e-10)


def test_world_functions_match_jax():
    """The world-level functions over two skeletons (a free box and the
    static ground): world_fk, world_full_kinematics, world_mass_matrix,
    world_forward_dynamics, world_integrate_positions, the state split and
    the action scatter, to 1e-10."""
    from nimblephysics_tpu.simulation import world as jwm

    from nimblephysics_tpu_torch.simulation import world as twm

    jw, tw = _pair(W.free_box(), W.ground_plane())
    jw.set_action_space([3, 5])
    tw.set_action_space([3, 5])
    rng = np.random.RandomState(3)
    q, v, tau = (rng.randn(6) for _ in range(3))

    def jax_side(q, v, tau):
        kin = jwm.world_full_kinematics(jw, q, v)
        return (jwm.world_fk(jw, q), kin["T_wb"], kin["V"], kin["J_world"],
                jwm.world_mass_matrix(jw, q), jwm.world_forward_dynamics(jw, q, v, tau),
                jwm.world_integrate_positions(jw, q, v, 0.01),
                jw.action_to_forces(tau[:2]), jw.forces_to_action(tau))

    tq, tv, tt = t64(q), t64(v), t64(tau)
    kin = twm.world_full_kinematics(tw, tq, tv)
    got = (twm.world_fk(tw, tq), kin["T_wb"], kin["V"], kin["J_world"],
           twm.world_mass_matrix(tw, tq), twm.world_forward_dynamics(tw, tq, tv, tt),
           twm.world_integrate_positions(tw, tq, tv, 0.01),
           tw.action_to_forces(tt[:2]), tw.forces_to_action(tt))
    for x, y in zip(got, jax.jit(jax_side)(q, v, tau)):
        close(x, y, atol=1e-10, rtol=1e-10)
    state = twm.merge_state(tq, tv)
    assert tw.state_size == 12 and tw.dof_offsets() == jw.dof_offsets() == [0, 6]
    assert all(torch.equal(x, y) for x, y in zip(twm.split_state(tw, state), (tq, tv)))


# ---------------------------------------------------------------------------
# The narrowphase
# ---------------------------------------------------------------------------


def _poses(rng, n, spread=0.15):
    R = np.asarray(jlie.exp_map_rot(jnp.asarray(rng.randn(n, 3))))
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = spread * rng.randn(n, 3)
    return T


PAIRS = {
    "sphere_plane": (lambda T1, T2: (T1[:3, 3], 0.2, T2[:3, 2], 0.05), 1),
    "sphere_sphere": (lambda T1, T2: (T1[:3, 3], 0.15, T2[:3, 3], 0.1), 1),
    "sphere_box": (lambda T1, T2: (T1[:3, 3], 0.1, T2, np.array([0.1, 0.15, 0.12])), 1),
    "box_plane": (lambda T1, T2: (T1, np.array([0.1, 0.2, 0.15]), T2[:3, 2], 0.02), 8),
    "capsule_plane": (lambda T1, T2: (T1, 0.05, 0.3, T2[:3, 2], 0.02), 2),
    "capsule_sphere": (lambda T1, T2: (T1, 0.05, 0.3, T2[:3, 3], 0.1), 1),
    "capsule_capsule": (lambda T1, T2: (T1, 0.05, 0.3, T2, 0.04, 0.25), 1),
    "capsule_box": (lambda T1, T2: (T1, 0.05, 0.3, T2, np.array([0.1, 0.15, 0.12])), 3),
    "box_box_sat": (lambda T1, T2: (T1, np.array([0.1, 0.15, 0.12]), T2,
                                    np.array([0.12, 0.08, 0.1])), 8),
}


@pytest.mark.parametrize("pair", PAIRS)
def test_narrowphase_pairs_match_jax(pair):
    """16 seeded pose pairs (most of them overlapping) per primitive pair,
    points, normals and depths to 1e-10."""
    make, k = PAIRS[pair]
    rng = np.random.RandomState(2)
    T1, T2 = _poses(rng, 16), _poses(rng, 16)
    jfn = getattr(jnp_np, pair)
    want = jax.jit(jax.vmap(lambda a, b: jfn(*make(a, b))))(T1, T2)
    tfn = getattr(tnp, pair)
    for i in range(16):
        args = [t64(x) if isinstance(x, np.ndarray) else x
                for x in make(T1[i], T2[i])]
        got = tfn(*args)
        assert got[0].shape == (k, 3) and got[2].shape == (k,)
        for x, y in zip(got, want):
            close(x, y[i], atol=1e-10, rtol=1e-10)
    assert (np.asarray(want[2]) > 0).any()
    assert float(tnp.ellipsoid_as_sphere([0.2, 0.3, 0.4])) == pytest.approx(0.15)


# ---------------------------------------------------------------------------
# Rows and the LCP
# ---------------------------------------------------------------------------


def _servo_limit_world():
    """A double pendulum with its second joint limited (active), a
    box-bounded servo on the first, and a ball constraint holding the
    second link's tip to a static anchor body."""
    from nimblephysics_tpu.dynamics import Skeleton

    sk = Skeleton("limited")
    b0 = sk.add_joint_and_body(
        "revolute", parent=-1, name="link0", axis=[0.0, 1.0, 0.0], T_cj=W.T(p=(0, 0, 0.5)),
        mass=1.0, inertia=np.eye(3) / 12.0)
    sk.add_joint_and_body(
        "revolute", parent=b0, name="link1", axis=[0.0, 1.0, 0.0],
        T_pj=W.T(p=(0, 0, -0.5)), T_cj=W.T(p=(0, 0, 0.5)), mass=1.0,
        inertia=np.eye(3) / 12.0, position_lower=[-0.3], position_upper=[0.3])
    anchor = Skeleton("anchor")
    anchor.add_joint_and_body("weld", name="anchor", mass=1.0)
    jw, _ = _pair(sk, anchor)
    jw.set_actuator_type(0, "servo", force_limit=2.0)
    jw.add_ball_joint_constraint(1, np.array([0.0, 0.0, -0.5]), 2,
                                 np.array([0.0, 0.0, -1.5]))
    return jw, world_from_arrays(dump_world(jw))


def _contact_state(name):
    """(JAX world, port world, q, v, u) of a state in contact."""
    from nimblephysics_tpu.models import box_drop as jbox
    from nimblephysics_tpu.models import half_cheetah as jhc

    rng = np.random.RandomState(4)
    if name == "half_cheetah":
        jw, q0, _ = jhc()
        q = q0 + 0.02 * rng.randn(9)
        q[1] -= 0.25
        v, u = 0.05 * rng.randn(9), 0.3 * rng.randn(9)
    elif name == "box_drop":
        # One corner down (a tilt about x and y), 1 mm into the ground and
        # approaching it: three live rows, independent.
        jw, _, _ = jbox()
        half = np.array([0.1, 0.1, 0.1])
        R = np.asarray(jlie.exp_map_rot(jnp.array([0.5, 0.4, 0.0])))
        q = np.r_[0.5, 0.4, 0.0, 0.0, 0.0, np.max(np.abs(R) @ half) - 1e-3]
        v = np.r_[0.3 * rng.randn(3), 0.2, -0.1, -0.8]
        u = np.zeros(6)
    elif name == "box_flat":
        # Flat, 1 mm into the ground and approaching it: four live corners.
        jw, _, _ = jbox()
        q, v, u = np.r_[0, 0, 0, 0, 0, 0.1 - 1e-3], np.r_[0, 0, 0, 0.2, 0, -0.8], np.zeros(6)
    else:
        jw, _ = _servo_limit_world()
        q, v, u = np.array([0.4, 0.35]), np.array([0.5, 1.0]), np.array([3.0, 0.0])
    return jw, world_from_arrays(dump_world(jw)), q, v, u


@pytest.mark.parametrize("name", ["half_cheetah", "box_drop", "servo_limit"])
def test_assemble_matches_jax(name):
    """Collision and the assembled rows (J, b, mu, valid) at a state in
    contact, against the JAX collider and assembler under one jax.jit."""
    jw, tw, q, v, u = _contact_state(name)
    je, te = JaxEngine(jw), Engine(tw, device="cpu")

    def jax_side(q, v, u):
        kin = jax.tree_util.tree_map(
            lambda *x: jnp.concatenate(x), *[
                {"T_wb": k["T_wb"], "J_world": jnp.pad(
                    k["J_world"], ((0, 0), (0, 0), (s, jw.num_dofs - e)))}
                for k, (s, e) in ((jsk.full_kinematics(sk, q[s:e]), (s, e))
                                  for sk, (s, e) in zip(jw.skeletons, jw.dof_slices()))])
        c = je.collider.collide(q, T_wb=kin["T_wb"])
        rows = je.assembler.assemble(q, v, c, kin["J_world"], T_wb=kin["T_wb"], control=u)
        return (c.point, c.normal, c.depth), rows

    (cp, cn, cd), rows = jax.jit(jax_side)(q, v, u)
    tq, tv, tu = t64(q), t64(v), t64(u)
    _, _, kin = te._chol_and_bias(tq, tv)
    c = te.collider.collide(tq, T_wb=kin["T_wb"])
    for x, y in zip((c.point, c.normal, c.depth), (cp, cn, cd)):
        close(x, y, atol=1e-10, rtol=1e-10)
    got = te.assembler.assemble(tq, tv, c, kin["J_world"], T_wb=kin["T_wb"], control=tu)
    for x, y in zip(got[:3], rows[:3]):
        close(x, y, atol=1e-10, rtol=1e-10)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(rows[3]))
    assert bool(got[3].any())


def _lcp(name, k_active=None):
    """The boxed LCP the JAX engine assembles at _contact_state(name):
    (meta, F, b, mu, z_warm)."""
    jw, _, q, v, u = _contact_state(name)
    je = JaxEngine(jw)
    kin, Ls = None, []
    rows = je.assembler.num_rows
    Lsd, bias, kin = je._chol_and_bias(jnp.asarray(q), jnp.asarray(v))
    v_pre = jnp.asarray(v) + jw.time_step * je._minv_apply(Lsd, jnp.asarray(u) - bias)
    c = je.collider.collide(jnp.asarray(q), T_wb=kin["T_wb"])
    Jm, b, mu, _ = je.assembler.assemble(jnp.asarray(q), v_pre, c, kin["J_world"],
                                         T_wb=kin["T_wb"], control=jnp.asarray(u))
    F = np.zeros((rows, jw.num_dofs))
    for k, (s, e) in enumerate(jw.dof_slices()):
        if e > s:
            F[:, s:e] = np.linalg.solve(np.asarray(Lsd[k]), np.asarray(Jm)[:, s:e].T).T
    meta = je.assembler.meta
    if k_active is not None:
        meta = dataclasses.replace(meta, k_active=k_active, refine_rounds=0)
    rng = np.random.RandomState(5)
    return meta, F, np.asarray(b), np.asarray(mu), 0.01 * np.abs(rng.randn(rows))


@pytest.mark.parametrize("case", ["box_drop", "box_drop_seed"])
def test_boxed_lcp_and_vjp_match_jax(case):
    """boxed_lcp's impulses to 1e-9 and its VJP in (F, b, mu) against
    jax.vjp (atol 1e-8, rtol 1e-7). "box_drop_seed" lands the box flat
    (four corners) and holds one clamping row in the pinned system
    (k_active = 1, no refinement), so that every pinned rung fails and
    the ladder returns the seed: the gradient runs through the unrolled
    APGD and its 16 PGS sweeps."""
    from nimblephysics_tpu.constraint import lcp as jlcp

    meta, F, b, mu, z0 = _lcp("box_flat" if "seed" in case else case,
                              1 if "seed" in case else None)
    cot = np.random.RandomState(6).randn(meta.n)
    f = jax.jit(lambda F, b, mu: jlcp.boxed_lcp(meta, F, b, mu, z0))
    z_j, vjp = jax.vjp(f, F, b, mu)
    g_j = vjp(jnp.asarray(cot))
    tF, tb, tmu = (t64(x).requires_grad_() for x in (F, b, mu))
    z = tlcp.boxed_lcp(meta, tF, tb, tmu, t64(z0))
    close(z, z_j, atol=1e-9, rtol=1e-9)
    assert float(np.abs(np.asarray(z_j)).max()) > 0
    g = torch.autograd.grad(z, (tF, tb, tmu), t64(cot))
    for x, y in zip(g, g_j):
        close(x, y, atol=1e-8, rtol=1e-7)
    if "seed" in case:
        zs = tlcp._pgs(dataclasses.replace(meta, iterations=meta.seed_pgs_sweeps),
                       t64(F), 0.0, t64(b), t64(mu),
                       tlcp._apgd(meta, t64(F), 0.0, t64(b), t64(mu), t64(z0)))
        close(z, zs, atol=1e-14)


# ---------------------------------------------------------------------------
# Engine.step
# ---------------------------------------------------------------------------


def _rows_F(te, q, v, u):
    """The port's F = J L^-T (n, nv) of a step at (q, v, u)."""
    return te.lcp_problem(q, v, u).F.numpy()


def close_impulses(z, z_j, F, null_atol=1e-7):
    """Impulses to 1e-9 along F's column space (what they do: F^T z sets
    v). A redundant contact set (four corners of a box flat on the
    ground) leaves z unique only up to F^T's null space, where the JAX
    package's gathered ridged solve amplifies roundoff (the port's keeps
    z in the row space of its clamping rows): the JAX package's own
    batched and single-world engines part there by 5.6e-9 on the resting
    box. That part is held to null_atol, 1e-7 unless a caller with a
    larger null space says otherwise."""
    dz = _np(z) - np.asarray(z_j)
    U, S, _ = np.linalg.svd(F, full_matrices=False)
    U = U[:, S > 1e-10 * max(S.max(initial=0.0), 1e-300)]
    along = U @ (U.T @ dz)
    np.testing.assert_allclose(along, 0.0, atol=1e-9 * (1.0 + np.abs(z_j).max(initial=0.0)))
    np.testing.assert_allclose(dz - along, 0.0, atol=null_atol)


def _step_world(name):
    """(JAX world, port world, q, v, u) of the step tests."""
    from nimblephysics_tpu.models import box_drop as jbox
    from nimblephysics_tpu.models import cartpole as jcart

    rng = np.random.RandomState(8)
    if name == "cartpole":
        jw, q0, _ = jcart()
        return (jw, None, q0 + np.array([0.9, 1.5]), 0.3 * rng.randn(2), 0.3 * rng.randn(2))
    if name == "box_drop":
        jw, _, _ = jbox()
        q = np.r_[0.1 * rng.randn(3), 0.0, 0.0, 0.1 + 1e-3]
        return jw, None, q, np.r_[0.5 * rng.randn(3), 0.2, 0.0, -0.8], np.zeros(6)
    if name == "resting_box":
        jw, _ = _pair(W.free_box(friction=1.0), W.ground_plane())
        return jw, None, np.r_[0.0, 0.0, 0.0, 0.0, 0.0, 0.1 - 1e-5], np.zeros(6), np.r_[0, 0, 0, 4.0, 0, 0]
    if name == "bouncing_sphere":
        jw, _ = _pair(W.free_sphere(radius=0.1, restitution=0.6), W.ground_plane())
        return jw, None, np.r_[0, 0, 0, 0, 0, 0.0999], np.r_[0, 0, 0, 0.3, 0, -2.0], np.zeros(6)
    jw, _, q, v, u = _contact_state("servo_limit")
    return jw, None, q, v, u


STEP_WORLDS = ["cartpole", "box_drop", "resting_box", "bouncing_sphere", "servo_limit"]


@pytest.mark.parametrize("name", STEP_WORLDS)
def test_step_matches_jax_engine(name):
    """Four warm-started steps: q to 1e-10, v and the impulses to 1e-9
    (tests/test_batched.py's levels)."""
    jw, _, q, v, u = _step_world(name)
    tw = world_from_arrays(dump_world(jw))
    je, te = JaxEngine(jw), Engine(tw, device="cpu")
    f = jax.jit(lambda q, v, u, z: je.step(q, v, u, z_warm=z))
    z = np.zeros(je.num_constraint_rows)
    tq, tv, tz = t64(q), t64(v), t64(z)
    saw = False
    for _ in range(4):
        r = f(q, v, u, z)
        s = te.step(tq, tv, t64(u), z_warm=tz)
        close(s.q, r.q, atol=1e-10, rtol=1e-10)
        close(s.v, r.v, atol=1e-9, rtol=1e-9)
        if z.size:
            close_impulses(s.impulses, r.impulses, _rows_F(te, tq, tv, t64(u)))
        close(s.v_pre, r.v_pre, atol=1e-9, rtol=1e-9)
        # The contact forces are the contact impulses over dt in the world
        # frame (on the JAX normals and tangent basis).
        if s.contact_forces.shape[0]:
            n = np.asarray(r.contact_normals)
            t1, t2 = (np.asarray(x) for x in jasm.tangent_basis(r.contact_normals))
            zc = s.impulses.numpy()[: 3 * n.shape[0]].reshape(-1, 3)
            f_w = (n * zc[:, :1] + t1 * zc[:, 1:2] + t2 * zc[:, 2:]) / jw.time_step
            close(s.contact_forces, f_w, atol=1e-9, rtol=1e-9)
        saw |= bool(np.abs(np.asarray(r.impulses)).max() > 0) if z.size else False
        q, v, z = np.asarray(r.q), np.asarray(r.v), np.asarray(r.impulses)
        tq, tv, tz = s.q, s.v, s.impulses
    if name != "cartpole":
        assert saw, "the case must exercise the LCP"


def test_half_cheetah_step_matches_jax_engine():
    """The half-cheetah's forward step from a state with its feet in
    contact, four warm-started steps (the JAX engine's gradient is not
    compiled here; the batched comparison below holds it)."""
    jw, _, q, v, u = _contact_state("half_cheetah")
    tw = world_from_arrays(dump_world(jw))
    je, te = JaxEngine(jw), Engine(tw, device="cpu")
    f = jax.jit(lambda q, v, u, z: je.step(q, v, u, z_warm=z))
    z = np.zeros(je.num_constraint_rows)
    tq, tv, tz = t64(q), t64(v), t64(z)
    for _ in range(4):
        r = f(q, v, u, z)
        s = te.step(tq, tv, t64(u), z_warm=tz)
        close(s.q, r.q, atol=1e-10, rtol=1e-10)
        close(s.v, r.v, atol=1e-9, rtol=1e-9)
        close(s.impulses, r.impulses, atol=1e-9, rtol=1e-9)
        q, v, z = np.asarray(r.q), np.asarray(r.v), np.asarray(r.impulses)
        tq, tv, tz = s.q, s.v, s.impulses
    assert np.abs(z).max() > 0


@pytest.mark.parametrize("name", ["box_drop", "pendulum", "servo_limit_pgs"])
def test_step_vjp_matches_jax(name):
    """The VJP of sum(w . [q', v', z']) in (q, v, control, masses)
    against jax.vjp: atol 1e-8, rtol 1e-7. "servo_limit_pgs" seeds its
    LCP with projected Gauss-Seidel (SolverConfig.lcp_solver "pgs"), so
    the backward pass runs through the PGS sweeps' graph."""
    if name == "pendulum":
        jw, _ = _pair(W.pendulum())
        q, v, u = np.array([0.4]), np.array([-0.3]), np.array([0.7])
    elif name == "servo_limit_pgs":
        from nimblephysics_tpu.simulation.world import SolverConfig as JaxCfg

        jw, _, q, v, u = _contact_state("servo_limit")
        jw.solver = JaxCfg(lcp_solver="pgs")
    else:
        jw, _, q, v, u = _step_world("box_drop")
    tw = world_from_arrays(dump_world(jw))
    je, te = JaxEngine(jw), Engine(tw, device="cpu")
    m = np.array([1.3] + [1.0] * (jw.num_bodies - 1))
    rng = np.random.RandomState(9)
    nr = je.num_constraint_rows
    wq, wv, wz = rng.randn(jw.num_dofs), rng.randn(jw.num_dofs), rng.randn(nr)

    def loss(q, v, u, m):
        r = je.step(q, v, u, body_params={"masses": m})
        return jnp.dot(wq, r.q) + jnp.dot(wv, r.v) + jnp.dot(wz, r.impulses)

    g_j = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(q, v, u, m)
    args = [t64(x).requires_grad_() for x in (q, v, u, m)]
    r = te.step(*args[:3], body_params={"masses": args[3]})
    val = r.q @ t64(wq) + r.v @ t64(wv) + r.impulses @ t64(wz)
    g = torch.autograd.grad(val, args)
    for x, y in zip(g, g_j):
        close(x, y, atol=1e-8, rtol=1e-7)


# ---------------------------------------------------------------------------
# The single world against the port's batched engine
# ---------------------------------------------------------------------------

BATCHED_CASES = [
    ("cartpole", 0.0),
    ("half_cheetah_air", 0.0),
    ("half_cheetah_ground", -0.55),
    ("box_drop", 0.0),
]


def _port_world(name):
    from nimblephysics_tpu_torch.models import box_drop, cartpole, half_cheetah

    mk = {"cartpole": cartpole, "box_drop": box_drop}.get(name, half_cheetah)
    return mk()


def _batch(q0, B, seed, drop, spread=0.03):
    rng = np.random.RandomState(seed)
    nv = len(q0)
    q = np.tile(np.asarray(q0, np.float64)[:, None], (1, B)) + spread * rng.randn(nv, B)
    q[1] += drop
    return q, 0.3 * rng.randn(nv, B), 0.3 * rng.randn(nv, B)


@pytest.mark.parametrize("name,drop", BATCHED_CASES, ids=[c[0] for c in BATCHED_CASES])
def test_single_world_matches_batched_engine(name, drop):
    """tests/test_batched.py's cases against the port's BatchedEngine at
    B = 4, four warm-started steps: q to 1e-10, v and impulses to 1e-9."""
    world, q0, _ = _port_world(name)
    eng = Engine(world, device="cpu")
    beng = BatchedEngine(world, device="cpu", dtype=torch.float64)
    q, v, u = (t64(x) for x in _batch(q0, 4, 7, drop))
    z = torch.zeros(eng.num_constraint_rows, 4, **F64)
    for _ in range(4):
        res = beng.step(q, v, u, z_warm=z)
        for w in range(4):
            r = eng.step(q[:, w], v[:, w], u[:, w], z_warm=z[:, w])
            close(r.q, res.q[:, w], atol=1e-10, rtol=1e-10)
            close(r.v, res.v[:, w], atol=1e-9, rtol=1e-9)
            close(r.impulses, res.impulses[:, w], atol=1e-9, rtol=1e-9)
        q, v, z = res.q, res.v, res.impulses


@pytest.mark.parametrize("drop", [-0.55, -0.25], ids=["deep", "feet_down"])
def test_gradients_match_batched_engine_through_contact(drop):
    """tests/test_batched.py's gradient check (B = 3): the gradient of
    sum(q'^2) + sum(v'^2) in (q, v, u), single world against the port's
    batched engine, atol 1e-8, rtol 1e-7; "feet_down" with the feet in
    the LCP's clipping range."""
    world, q0, _ = _port_world("half_cheetah")
    eng = Engine(world, device="cpu")
    beng = BatchedEngine(world, device="cpu", dtype=torch.float64)
    q, v, u = (t64(x).requires_grad_() for x in _batch(q0, 3, 3, drop, spread=0.02))
    r = beng.step(q, v, u)
    gb = torch.autograd.grad(torch.sum(r.q ** 2) + torch.sum(r.v ** 2), (q, v, u))
    impulses = 0.0
    for w in range(3):
        args = [x[:, w].detach().clone().requires_grad_() for x in (q, v, u)]
        s = eng.step(*args)
        impulses += float(s.impulses.detach().abs().sum())
        go = torch.autograd.grad(torch.sum(s.q ** 2) + torch.sum(s.v ** 2), args)
        for a, b in zip(go, gb):
            close(a, b[:, w], atol=1e-8, rtol=1e-7)
    if drop == -0.25:
        assert impulses > 0


# ---------------------------------------------------------------------------
# The public entry point
# ---------------------------------------------------------------------------


def test_timestep_is_state_step():
    """timestep(world, state, action, masses) steps on the state's device
    and dtype, as Engine.state_step, and checks its sizes."""
    world, q0, _ = _port_world("half_cheetah")
    state = t64(np.r_[q0, np.zeros(9)])
    action = t64(0.5 * np.ones(6))
    out = timestep(world, state, action, masses=torch.ones(world.num_bodies, **F64))
    eng = Engine(world, device="cpu")
    want = eng.state_step(state, action, torch.ones(world.num_bodies, **F64))
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="action_size"):
        timestep(world, state, t64(np.ones(9)))
    assert timestep(world, state.float(), action.float()).dtype == torch.float32

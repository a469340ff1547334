"""nimblephysics_tpu_torch's spline functions and spline-driven and
biomechanics joints against the JAX package, float64 on the CPU.

* every Fn kind (linear, constant, polynomial, natural spline, multiplier)
  at its knots, between them and in extrapolation: value and derivative
  to 1e-13, the second derivative to the JAX package's nested grad;
* the five joint types (custom, ellipsoid, scapulathoracic,
  constantcurve, constantcurveincompressible): Q(q), S(q) and S-dot to
  1e-12;
* the batched step on tests/test_batched.py's custom-joint and
  biomechanics skeletons (B = 3) and the single-world step on
  tests/test_biomech_joints.py's, to 1e-9: the port steps every joint's
  skeleton in one world, the JAX package each skeleton alone (one
  small compile a case);
* a VJP through the spline joint's batched step against finite
  differences of the port's own step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.batched import BatchedEngine as JaxBatched
from nimblephysics_tpu.dynamics import Skeleton as JaxSkeleton
from nimblephysics_tpu.dynamics import joints as JJ
from nimblephysics_tpu.math import splines as JS
from nimblephysics_tpu.neural.timestep import Engine as JaxEngine
from nimblephysics_tpu.simulation.world import World as JaxWorld

from nimblephysics_tpu_torch.batched import BatchedEngine
from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.dynamics import joints as TJ
from nimblephysics_tpu_torch.math import splines as TS
from nimblephysics_tpu_torch.neural import Engine
from torch_parity import F64, dump_world, n, t64

XS = np.linspace(-1.5, 1.5, 7)


def _fns(S):
    """The same function specs built by either package's splines module."""
    spline = S.simm_spline(XS, 0.3 * np.sin(XS))
    return {
        "linear": S.linear(1.7, -0.2),
        "constant": S.constant(0.05),
        "polynomial": S.polynomial([0.1, -0.2, 0.3, 0.7]),
        "spline": spline,
        "spline_2knots": S.simm_spline([0.0, 1.0], [0.2, -0.4]),
        "multiplier": S.multiplier(spline, -2.5),
    }


# Knots, points between them, and points outside on both sides.
POINTS = np.concatenate([XS, XS[:-1] + 0.37 * np.diff(XS), [-3.1, -1.6, 1.51, 2.9]])


@pytest.mark.parametrize("kind", list(_fns(JS)))
def test_fn_value_and_derivatives_match_jax(kind):
    jf, tf = _fns(JS)[kind], _fns(TS)[kind]
    x = t64(POINTS)
    np.testing.assert_allclose(n(tf(x)), [float(jf(jnp.asarray(p))) for p in POINTS],
                               atol=1e-13, rtol=0)
    d1 = [float(jf.derivative(jnp.asarray(p))) for p in POINTS]
    np.testing.assert_allclose(n(tf.derivative(x)), d1, atol=1e-13, rtol=0)
    d2 = [float(jax.grad(jax.grad(lambda xx: jf(xx)))(jnp.asarray(p))) for p in POINTS]
    np.testing.assert_allclose(n(tf.second_derivative(x)), d2, atol=1e-12, rtol=0)
    # The value's own autograd derivative agrees with the closed form.
    xg = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(tf(xg).sum(), xg)
    np.testing.assert_allclose(n(g), d1, atol=1e-13, rtol=0)


def test_spline_searchsorted_takes_the_left_side_at_knots():
    """At a knot both neighbouring cubics meet; the left side picks the
    cell below it, as jnp.searchsorted does: the same second derivative
    formula's weights (t = 1 of the lower cell)."""
    tf = _fns(TS)["spline"]
    m = tf.params[2]
    np.testing.assert_allclose(n(tf.second_derivative(t64(XS[1:-1]))), m[1:-1], atol=1e-14)


def _custom(mod, S):
    return mod.CustomJointDef(
        n_dofs=2, rot_axes=np.eye(3), trans_axes=np.eye(3),
        functions=(S.linear(1.0, 0.0), S.simm_spline(XS, 0.3 * np.sin(XS)),
                   S.constant(0.0), S.linear(0.2, 0.0), S.constant(0.05),
                   S.polynomial([0.1, -0.2, 0.3])),
        drives=(0, 1, -1, 0, -1, 1))


BIOMECH_TYPES = [
    ("ellipsoid", {"radii": (0.07, 0.05, 0.09)}),
    ("scapulathoracic", {"radii": (0.07, 0.05, 0.09), "winging_axis_offset": (0.02, -0.01),
                         "winging_axis_direction": 0.4}),
    ("constantcurve", {"neutral": (0.0, 0.0, 0.0, 0.3)}),
    ("constantcurveincompressible", {"length": 0.35, "neutral": (0.05, 0.0, -0.02)}),
]
JOINTS = [("custom", None)] + BIOMECH_TYPES


def _spec(mod, S, jt, props):
    return mod.JointSpec(joint_type=jt, name="j", parent=-1, child=0, q_index=0,
                         T_pj=np.eye(4), T_cj=np.eye(4), props=props,
                         custom=_custom(mod, S) if jt == "custom" else None)


@pytest.mark.parametrize("jt,props", JOINTS, ids=[j[0] for j in JOINTS])
def test_joint_kinematics_match_jax(jt, props):
    js, ts = _spec(JJ, JS, jt, props), _spec(TJ, TS, jt, props)
    assert ts.num_dofs == js.num_dofs
    rng = np.random.RandomState(5)
    for scale in (0.5, 1.3):  # the second reaches the spline's extrapolation
        q, dq = scale * rng.randn(js.num_dofs), rng.randn(js.num_dofs)
        jq, tq = jnp.asarray(q), t64(q)
        np.testing.assert_allclose(n(TJ.joint_transform(ts, tq)),
                                   np.asarray(JJ.joint_transform(js, jq)), atol=1e-12)
        np.testing.assert_allclose(n(TJ.joint_body_jacobian(ts, tq)),
                                   np.asarray(JJ.joint_body_jacobian(js, jq)), atol=1e-12)
        np.testing.assert_allclose(
            n(TJ.joint_body_jacobian_dot(ts, tq, t64(dq))),
            np.asarray(JJ.joint_body_jacobian_dot(js, jq, jnp.asarray(dq))), atol=1e-12)


def _jax_skeleton(jt, props, tip):
    """The custom joint alone (tests/test_batched.py's, with a polynomial
    on the last axis); a biomechanics joint with a revolute tip hung off
    it (tests/test_batched.py's) or alone (tests/test_biomech_joints.py's
    test_dynamics_with_joint)."""
    sk = JaxSkeleton(f"bio_{jt}")
    if jt == "custom":
        sk.add_joint_and_body("custom", parent=-1, name="seg", custom=_custom(JJ, JS),
                              mass=1.1, inertia=np.eye(3) * 0.02)
        return sk
    a = sk.add_joint_and_body(jt, parent=-1, name="seg", props=props, mass=1.5,
                              com=(0.0, 0.05, 0.0), inertia=np.eye(3) * 0.01)
    if tip:
        sk.add_joint_and_body(
            "revolute", parent=a, name="tip", axis=(0, 0, 1),
            T_pj=np.array([[1, 0, 0, 0.05], [0, 1, 0, 0.1], [0, 0, 1, 0], [0, 0, 0, 1.0]]),
            mass=0.4, inertia=np.eye(3) * 0.005)
    return sk


def _zoo(tip):
    """One world holding every joint's skeleton, gravity -y; and each
    joint's dof slice."""
    w = JaxWorld(gravity=(0.0, -9.81, 0.0), time_step=0.001)
    for jt, props in JOINTS:
        w.add_skeleton(_jax_skeleton(jt, props, tip))
    return w, dict(zip([j[0] for j in JOINTS], w.dof_slices()))


def _alone(jt, tip):
    """Joint jt's zoo skeleton alone in a world like the zoo's. The zoo's
    skeletons share no contact and no constraint row, so its step is the
    zoo's on its dofs; the JAX side compiles this world, a few seconds a
    case (the whole zoo's step took 28-55 s to compile, again in each test
    worker that ran one of its cases)."""
    w = JaxWorld(gravity=(0.0, -9.81, 0.0), time_step=0.001)
    w.add_skeleton(_jax_skeleton(jt, dict(JOINTS)[jt], tip))
    return w


@pytest.fixture(scope="module")
def batched_zoo():
    """The port's batched step of the zoo with tips from seeded (nv, 3)
    inputs; the inputs and each joint's dof slice."""
    jw, slices = _zoo(tip=True)
    nv = jw.num_dofs
    rng = np.random.RandomState(11)
    q, v, u = 0.5 * rng.randn(nv, 3), 0.5 * rng.randn(nv, 3), 0.2 * rng.randn(nv, 3)
    te = BatchedEngine(world_from_arrays(dump_world(jw)), **F64)
    return (q, v, u), te.step(t64(q), t64(v), t64(u)), slices


@pytest.mark.parametrize("jt", [j[0] for j in JOINTS])
def test_batched_step_matches_jax(batched_zoo, jt):
    """The joint's dofs of the port's zoo step against the JAX batched
    engine's step of its skeleton alone (jitted once) from the same
    inputs."""
    xs, tr, slices = batched_zoo
    s, e = slices[jt]
    je = JaxBatched(_alone(jt, tip=True))
    jr = jax.jit(lambda q, v, u: je.step(q, v, u))(*(jnp.asarray(x[s:e]) for x in xs))
    np.testing.assert_allclose(n(tr.q)[s:e], np.asarray(jr.q), atol=1e-9, rtol=0)
    np.testing.assert_allclose(n(tr.v)[s:e], np.asarray(jr.v), atol=1e-9, rtol=0)


@pytest.fixture(scope="module")
def single_zoo():
    """The port's single-world step of the zoo without tips, from
    tests/test_biomech_joints.py's seeded state scale; the inputs and each
    joint's dof slice."""
    jw, slices = _zoo(tip=False)
    nv = jw.num_dofs
    rng = np.random.RandomState(3)
    q, v, u = (0.3 * rng.randn(nv) for _ in range(3))
    tr = Engine(world_from_arrays(dump_world(jw)), device="cpu").step(t64(q), t64(v), t64(u))
    return (q, v, u), tr, slices


@pytest.mark.parametrize("jt", [j[0] for j in JOINTS])
def test_single_world_step_matches_jax(single_zoo, jt):
    """The joint's dofs of the port's zoo step against the JAX single-world
    Engine's step of its skeleton alone (jitted once)."""
    xs, tr, slices = single_zoo
    s, e = slices[jt]
    je = JaxEngine(_alone(jt, tip=False))
    jr = jax.jit(lambda q, v, u: je.step(q, v, u))(*(jnp.asarray(x[s:e]) for x in xs))
    np.testing.assert_allclose(n(tr.q)[s:e], np.asarray(jr.q), atol=1e-9, rtol=0)
    np.testing.assert_allclose(n(tr.v)[s:e], np.asarray(jr.v), atol=1e-9, rtol=0)


def test_spline_joint_step_vjp_matches_finite_differences():
    """d(w . [q'; v'])/d(q, v) of the custom joint's batched step (the
    forward-mode S and S-dot inside a reverse pass) against central
    differences of the port's own step."""
    from nimblephysics_tpu_torch.dynamics import Skeleton
    from nimblephysics_tpu_torch.simulation import World

    sk = Skeleton("custom")
    sk.add_joint_and_body("custom", custom=_custom(TJ, TS), mass=1.1, inertia=np.eye(3) * 0.02)
    w = World(gravity=(0.0, 0.0, -9.81), time_step=0.001)
    w.add_skeleton(sk)
    te, nv = BatchedEngine(w, **F64), 2
    rng = np.random.RandomState(12)
    x0 = t64(0.6 * rng.randn(2 * nv, 2))
    u = t64(0.2 * rng.randn(nv, 2))
    wt = t64(rng.randn(2 * nv, 2))

    def f(x):
        r = te.step(x[:nv], x[nv:], u)
        return torch.sum(wt * torch.cat([r.q, r.v]))

    x = x0.clone().requires_grad_()
    (g,) = torch.autograd.grad(f(x), x)
    fd = torch.zeros_like(x0)
    h = 1e-6
    for i in range(x0.shape[0]):
        for b in range(x0.shape[1]):
            e = torch.zeros_like(x0)
            e[i, b] = h
            fd[i, b] = (f(x0 + e) - f(x0 - e)) / (2 * h)
    np.testing.assert_allclose(n(g), n(fd), atol=1e-7, rtol=1e-6)

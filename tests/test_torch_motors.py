"""The port's motor, ball and weld rows and its box-bounded LCP against
the JAX package, float64 on the CPU, B <= 4.

The scenes are chip_smoke.motor_scene's (the constraint families of
tests/test_motors.py built with the port's API), held against the same
worlds built from tests/worlds.py in the JAX package: their plans
(rows, bounds, islands), the captured weld pose, and the rows of one
step. No JAX engine step is compiled or run: the rows are held function
by function (jax.jit of fk and _assemble, contacts passed in), the
box-bounded classification, pinned solve and refine round on a hand-made
LCP, and the steps themselves by tests/test_motors.py's own checks and
against finite differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.batched import BatchedEngine as JaxEngine
from nimblephysics_tpu.batched import articulated as ja
from nimblephysics_tpu.batched import lcp as jlcp
from nimblephysics_tpu.constraint.lcp import LcpMeta as JaxMeta
from nimblephysics_tpu.simulation import World as JaxWorld

import chip_smoke
from nimblephysics_tpu_torch.batched import BatchedEngine
from nimblephysics_tpu_torch.batched import lcp as tlcp
from nimblephysics_tpu_torch.constraint.lcp import LcpMeta
from nimblephysics_tpu_torch.simulation import World
from torch_parity import F64, assert_same_plan, n, t64
from worlds import double_pendulum, free_box, ground_plane, pendulum

B = 3
SCENES = chip_smoke.MOTOR_SCENES
# n rows and rank r of each scene's LCP: one motor row; the ball's 3 rows
# after 8 box-plane contacts; the weld's 6 after 8 box-box contacts.
SIZES = {"servo": (1, 1), "mimic": (1, 2), "locked": (1, 1), "ball": (27, 6),
         "weld": (30, 12)}


def _jax_scene(name):
    """The JAX package's world of motor_scene(name), from tests/worlds.py."""
    if name in ("servo", "mimic", "locked"):
        w = JaxWorld(gravity=(0.0, 0.0, -9.81 if name == "locked" else 0.0))
        w.add_skeleton(double_pendulum() if name == "mimic" else pendulum())
        if name == "servo":
            w.set_actuator_type(0, "servo", force_limit=0.01)
        elif name == "mimic":
            w.set_actuator_type(1, "mimic", force_limit=1e4, mimic_dof=0,
                                mimic_multiplier=0.5)
        else:
            w.set_actuator_type(0, "locked")
        return w
    w = JaxWorld(time_step=1e-3)
    w.add_skeleton(free_box())
    if name == "ball":
        w.add_skeleton(ground_plane())
        w.add_ball_joint_constraint(0, [0.1, 0.0, 0.1], 1, [0.1, 0.0, 1.0])
    else:
        w.add_skeleton(free_box())
        q0 = np.zeros(12)
        q0[9], q0[11] = 0.4, 0.1
        w.add_weld_joint_constraint(0, 1, at_positions=q0)
    return w


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name in SCENES:
        tw, q0, v0, u0 = chip_smoke.motor_scene(name)
        jw = _jax_scene(name)
        out[name] = (jw, JaxEngine(jw), tw, BatchedEngine(tw, **F64), q0, v0, u0)
    return out


@pytest.mark.parametrize("name", SCENES)
def test_motor_scene_plans_match_jax(scenes, name):
    """Slots, rows, the LcpMeta with its bounds (servo and mimic +-force
    limit x dt, locked, ball and weld rows unbounded), islands; and the
    ball and weld entries, the weld's pose captured by the port's own
    forward kinematics (to 1e-14)."""
    jw, je, tw, te, *_ = scenes[name]
    assert_same_plan(te, je)
    assert (te.num_rows, tw.num_dofs) == SIZES[name]
    lo, hi = te.meta.lo_const[-1], te.meta.hi_const[-1]
    if name in ("servo", "mimic"):
        limit = tw.actuator_types[tw.num_dofs - 1]["force_limit"] * tw.time_step
        assert (lo, hi) == (-limit, limit)
    else:
        assert (lo, hi) == (-np.inf, np.inf)
    for tc, jc in zip(tw.dynamic_constraints, jw.dynamic_constraints):
        assert tc.keys() == jc.keys() and tc["kind"] == jc["kind"]
        for k in set(tc) - {"kind"}:
            np.testing.assert_allclose(np.asarray(tc[k]), np.asarray(jc[k]),
                                       rtol=0, atol=1e-14)


def test_constraint_between_skeletons_joins_islands():
    """Three boxes on the ground with box-box pairs filtered off are three
    islands; a weld between the first two makes them one (JAX plans)."""
    def build(world_cls, box, ground, weld):
        w = world_cls(time_step=1e-3)
        for _ in range(3):
            w.add_skeleton(box())
        w.add_skeleton(ground())
        for i in range(3):
            for j in range(i + 1, 3):
                w.collision_overrides[(i, j)] = False
        if weld:
            q = np.zeros(18)
            q[9] = 0.5
            w.add_weld_joint_constraint(0, 1, at_positions=q)
        return w

    for weld, count in ((False, 3), (True, 2)):
        jw = build(JaxWorld, free_box, ground_plane, weld)
        tw = build(World, chip_smoke._free_box, chip_smoke._ground, weld)
        je, te = JaxEngine(jw), BatchedEngine(tw, **F64)
        assert_same_plan(te, je)
        assert len(te.islands) == count


def _jax_rows(je):
    """The JAX package's rows for given contacts: fk, then _assemble."""
    def rows(q, v_pre, u, cp, cn, cd):
        R, p, W, _, _ = ja.fk(je.fw, q)
        return je._assemble(q, v_pre, cp, cn, cd, W, R, p, u)

    return jax.jit(rows)


@pytest.mark.parametrize("name", SCENES)
def test_motor_rows_match_jax(scenes, name):
    """J, b, mu and valid of every row, from seeded states near the
    scene's start (the contacts each side's own; box-plane and box-box are
    held in test_torch_collision.py and test_torch_boxstack.py), to 1e-12."""
    from nimblephysics_tpu_torch.batched.articulated import fk

    jw, je, tw, te, q0, v0, u0 = scenes[name]
    rng = np.random.RandomState(SCENES.index(name))
    nv = len(q0)
    q = q0[:, None] + 0.05 * rng.randn(nv, B)
    v_pre, u = rng.randn(nv, B), u0[:, None] + rng.randn(nv, B)
    R, p, W, _, _ = fk(te.fw, t64(q))
    cp, cn, cd = te.bcollider.collide(R, p, B)
    got = te._assemble(t64(q), t64(v_pre), cp, cn, cd, W, R, p, t64(u))
    want = _jax_rows(je)(*map(jnp.asarray, (q, v_pre, u, n(cp), n(cn), n(cd))))
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-12)
    assert np.abs(n(got[1])[-1]).max() > 1e-3  # the motor or constraint rows work


# -- box-bounded rows in the boxed LCP -----------------------------------------

# A contact (3 rows), then a row bounded to +-0.05 (a servo), one to +-1
# (a mimic), and 3 unbounded rows (a ball constraint).
_FINDEX = np.array([-1, 0, 0, -1, -1, -1, -1, -1], np.int32)
_LO = np.array([0.0] * 3 + [-0.05, -1.0] + [-np.inf] * 3)
_HI = np.array([np.inf] * 3 + [0.05, 1.0] + [np.inf] * 3)


def _boxed(seed):
    """(JAX meta, port meta, F (8, 8, 4), b, mu, z) of that plan (A well
    conditioned: F = I + 0.3 N(0, 1)), z
    feasible-signed with the servo row at its upper bound in world 0 and
    its lower bound in world 2."""
    kw = dict(findex=_FINDEX, is_friction=_FINDEX >= 0, lo_const=_LO, hi_const=_HI)
    rng = np.random.RandomState(seed)
    F = np.eye(8)[:, :, None] + 0.3 * rng.randn(8, 8, 4)
    b = rng.randn(8, 4)
    mu = np.where(_FINDEX[:, None] >= 0, 0.8, 0.0) * np.ones((1, 4))
    z = 0.3 * rng.randn(8, 4)
    z[0] = np.abs(z[0])
    z[3] = [0.05, 0.01, -0.05, 0.03]
    return JaxMeta(**kw), LcpMeta(**kw), F, b, mu, z


def test_boxed_classify_pinned_solve_and_refine_match_jax():
    """_classify (with at_hi) and one refine round exactly, and the pinned
    solve with rows fixed at their bounds (cfm 0 and the ladder's cfm) to
    1e-6, against the JAX package's (one jax.jit) on an LCP of contact,
    bounded and unbounded rows; some servo rows rest at their bounds. The
    JAX pinned solve itself moves by up to 4.6e-7 between jax.jit and op
    by op on such LCPs (its ridged normal equations), hence 1e-6."""
    jm, tm, F, b, mu, z = _boxed(3)
    targs = [t64(x) for x in (F, b, mu, z)]
    got = tlcp._classify(tm, targs[0], 0.0, *targs[1:])
    masks = got[0], got[1], torch.sign(targs[3]), got[2]

    def jax_side(F, b, mu, z, *m):
        return (jlcp._classify(jm, F, 0.0, b, mu, z),
                [jlcp._pinned_solve(jm, F, cfm, b, mu, *m[:3], at_hi=m[3])
                 for cfm in (0.0, 1e-4)],
                jlcp._refine_masks(jm, F, 0.0, b, mu, *m))

    want = jax.jit(jax_side)(*(jnp.asarray(x) for x in (F, b, mu, z)),
                             *(jnp.asarray(n(x)) for x in masks))
    for a, w in zip(got, want[0]):
        np.testing.assert_array_equal(n(a), n(w))
    assert n(got[2]).any() and not n(got[2]).all()  # some rows pinned at hi
    for cfm, w in zip((0.0, 1e-4), want[1]):
        got_z = tlcp._pinned_solve(tm, targs[0], cfm, targs[1], targs[2], *masks)
        np.testing.assert_allclose(n(got_z), n(w), rtol=1e-6, atol=1e-6)
    refined = tlcp._refine_masks(tm, targs[0], 0.0, targs[1], targs[2], *masks)
    for a, w in zip(refined, want[2]):
        np.testing.assert_array_equal(n(a), n(w))


# -- the steps: tests/test_motors.py's checks on the port ----------------------


def _step(name, q, v, u, world=None):
    tw = world or chip_smoke.motor_scene(name)[0]
    eng = BatchedEngine(tw, **F64)
    return eng, eng.step(t64(q)[:, None], t64(v)[:, None], t64(u)[:, None])


def test_servo_saturates_at_its_force_limit():
    """A servo of force limit 0.01 told 10 rad/s moves, but by one step of
    its limit: the impulse sits at its bound f dt and v = f dt / M (M =
    1/3 for the unit pendulum about its end), test_servo_respects_force_limit."""
    eng, r = _step("servo", [0.0], [0.0], [10.0])
    f_dt = 0.01 * eng.world.time_step
    np.testing.assert_allclose(n(r.impulses)[0, 0], f_dt, rtol=1e-12)
    np.testing.assert_allclose(n(r.v)[0, 0], 3.0 * f_dt, rtol=1e-10)


def test_servo_tracks_a_reachable_command():
    """A strong servo under gravity reaches its command in one step
    (test_servo_tracks_velocity_command)."""
    w = World(gravity=(0.0, 0.0, -9.81))
    w.add_skeleton(chip_smoke._pendulum(1))
    w.set_actuator_type(0, "servo", force_limit=1000.0)
    _, r = _step(None, [0.0], [0.0], [0.7], world=w)
    np.testing.assert_allclose(n(r.v)[0, 0], 0.7, atol=1e-8)


def test_locked_joint_stops():
    _, q0, v0, u0 = chip_smoke.motor_scene("locked")
    _, r = _step("locked", q0, v0, u0)
    np.testing.assert_allclose(n(r.v)[0, 0], 0.0, atol=1e-8)


def test_mimic_follows_half_its_leader():
    _, q0, v0, u0 = chip_smoke.motor_scene("mimic")
    _, r = _step("mimic", q0, v0, u0)
    v = n(r.v)[:, 0]
    np.testing.assert_allclose(v[1], 0.5 * v[0], atol=1e-6)
    assert abs(v[0]) > 0.1


def test_ball_and_weld_hold_over_a_rollout():
    """25 steps: the ball's anchor stays within 5e-3 of its world point
    while the box swings; the welded pair keeps its captured relative
    pose within 2e-3 while spinning (tests/test_motors.py's limits)."""
    for name in ("ball", "weld"):
        tw, q0, v0, u0 = chip_smoke.motor_scene(name)
        eng = BatchedEngine(tw, **F64)
        q, v, u = (t64(x)[:, None] for x in (q0, v0, u0))
        z = None
        for _ in range(25):
            r = eng.step(q, v, u, z_warm=z)
            q, v, z = r.q, r.v, r.impulses
        anchor, pose = chip_smoke.constraint_drift(eng, q)
        limit = 5e-3 if name == "ball" else 2e-3
        assert float(anchor.max()) < limit and float(pose.max()) < limit, name
        assert float(v.abs().max()) > 0.05  # it moves


# -- gradients through a saturated servo ---------------------------------------


def test_servo_step_vjp_matches_finite_differences():
    """A servo pendulum under gravity (force limit 1: the impulse bound is
    1e-3) in two worlds, one told 10 rad/s (saturated, its impulse pinned
    at the bound) and one a reachable 1e-3 above its free velocity: the
    VJP of step and remat_step in (q, v, control) along seeded directions
    against central differences (step 1e-5, relative 1e-6, the active set
    fixed within the difference); the saturated world's control gradient
    is 0."""
    w = World(gravity=(0.0, 0.0, -9.81))
    w.add_skeleton(chip_smoke._pendulum(1))
    w.set_actuator_type(0, "servo", force_limit=1.0)
    eng = BatchedEngine(w, **F64)
    q, v = np.array([[0.3, -0.2]]), np.array([[0.1, 0.0]])
    v_pre = n(eng.lcp_problem(t64(q), t64(v), t64(np.zeros((1, 2)))).v_pre)
    u = np.array([[10.0, v_pre[0, 1] + 1e-3]])
    rng = np.random.RandomState(7)
    wq, wv = t64(rng.randn(1, 2)), t64(rng.randn(1, 2))

    def loss(args, fn="step"):
        r = getattr(eng, fn)(*args)
        return (wq * r.q).sum() + (wv * r.v).sum(), r

    for fn in ("step", "remat_step"):
        x = [t64(a).requires_grad_() for a in (q, v, u)]
        L, r = loss(x, fn)
        grads = torch.autograd.grad(L, x)
        z = r.impulses.detach()
        assert float(z[0, 0]) == pytest.approx(1e-3, rel=1e-12)
        assert 0.0 < float(z[0, 1]) < 0.5e-3
        assert float(grads[2][0, 0]) == 0.0
        for _ in range(2):
            d = [rng.randn(*a.shape) for a in (q, v, u)]
            side = [float(loss([t64(a + sgn * 1e-5 * da) for a, da in zip((q, v, u), d)])[0])
                    for sgn in (1.0, -1.0)]
            fd = (side[0] - side[1]) / 2e-5
            ad = sum(float((g * t64(da)).sum()) for g, da in zip(grads, d))
            assert abs(fd - ad) <= 1e-6 * max(1.0, abs(ad)), (fn, fd, ad)

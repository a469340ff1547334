"""nimblephysics_tpu_torch.batched.collision against the JAX package's
batched/collision.py: contact points, normals and depths of every slot
from the same seeded float64 states (B=4), to atol 1e-10. Capsule-plane
slots come from the half-cheetah; sphere-plane slots from a sphere on a
vertical slider over a tilted plane, carried across with
convert.world_from_arrays. The sphere and capsule kinds (sphere-sphere,
sphere-box, capsule-sphere, capsule-capsule, capsule-box) alone, touching
and apart, and in a world of five free bodies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.batched import articulated as ja
from nimblephysics_tpu.batched import collision as jc
from nimblephysics_tpu.batched.collision import BatchedCollider as JaxCollider
from nimblephysics_tpu.collision import narrowphase as jn
from nimblephysics_tpu.collision.collider import Collider as JaxPlan
from nimblephysics_tpu.dynamics import PRISMATIC, WELD, ShapeSpec, Skeleton
from nimblephysics_tpu.simulation.world import World

from nimblephysics_tpu_torch.batched import articulated as ta
from nimblephysics_tpu_torch.batched import collision as tc
from nimblephysics_tpu_torch.batched import linalg as tl
from nimblephysics_tpu_torch.batched.collision import BatchedCollider
from nimblephysics_tpu_torch.collision.collider import Collider
from nimblephysics_tpu_torch.convert import world_from_arrays
from torch_parity import batch_states, dump_world, half_cheetah_pair, n, t64

B = 4


def _sphere_world():
    w = World(name="spheres", gravity=(0.0, -9.81, 0.0))
    ground = Skeleton("ground")
    tilt = np.eye(4)
    tilt[:3, :3] = [[1, 0, 0], [0, np.cos(0.2), -np.sin(0.2)],
                    [0, np.sin(0.2), np.cos(0.2)]]
    ground.add_joint_and_body(WELD, name="ground", T_pj=tilt, shapes=(
        ShapeSpec("plane", np.array([0.0, 1.0, 0.0, 0.0]), friction=0.7),))
    w.add_skeleton(ground)
    ball = Skeleton("ball")
    ball.add_joint_and_body(PRISMATIC, name="ball", axis=[0.0, 1.0, 0.0],
                            shapes=(ShapeSpec("sphere", np.array([0.1])),))
    w.add_skeleton(ball)
    return w


def _cases():
    jw, tw, q0 = half_cheetah_pair()
    sw = _sphere_world()
    return {
        "capsule_plane_air": (jw, tw, batch_states(q0, B, 3)[0]),
        "capsule_plane_ground": (jw, tw, batch_states(q0, B, 3, drop=-0.27)[0]),
        "sphere_plane": (sw, world_from_arrays(dump_world(sw)),
                         np.array([[0.12, 0.08, 0.3, -0.05]])),
    }


@pytest.mark.parametrize(
    "case", ["capsule_plane_air", "capsule_plane_ground", "sphere_plane"])
def test_collide_matches_jax(case):
    jw, tw, q = _cases()[case]
    jc = JaxCollider(JaxPlan(jw))
    tc = BatchedCollider(Collider(tw))
    assert tc.num_contacts == jc.num_contacts
    np.testing.assert_array_equal(tc.body_a, jc.body_a)
    jR, jp, *_ = ja.fk(ja.FlatWorld(jw), jnp.asarray(q))
    tR, tp, *_ = ta.fk(ta.FlatWorld(tw), t64(q))
    Bq = q.shape[1]
    want = jc.collide(jR, jp, Bq)
    got = tc.collide(tR, tp, Bq)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), atol=1e-10)
    if case != "capsule_plane_air":
        assert (n(got[2]) > 0).any()


# -- sphere and capsule pair kinds ------------------------------------------------

R_A, R_B = 0.1, 0.12  # sphere radii (B's is the second sphere's)
CAP_A, CAP_B = (0.05, 0.3), (0.04, 0.2)  # capsule (radius, height)
HALF = np.array([0.1, 0.15, 0.2])  # box half sizes


def _pose(seed, gap):
    """Seeded rotations of A and B (3, 3, B) and positions (3, B): B's
    centre at distance ~0.2 + gap from A's along a random direction."""
    rng = np.random.RandomState(seed)
    Ra, Rb = (n(tl.exp_so3(t64(rng.randn(3, B)))) for _ in range(2))
    d = rng.randn(3, B)
    pa = 0.1 * rng.randn(3, B)
    return Ra, pa, Rb, pa + (0.2 + gap) * d / np.linalg.norm(d, axis=0)


def _c(x):
    return t64(np.asarray(x, np.float64).reshape(1, -1, 1))


def _capsule_box_jax(Ra, pa, Rb, pb):
    """narrowphase.capsule_box (3 contacts) over the batch: what the JAX
    package's slot plan gives the pair (its batched capsule_box_b returns
    only the 2 end spheres)."""
    def T(R, p):
        return jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(p)

    one = jax.vmap(lambda R1, p1, R2, p2: jn.capsule_box(
        T(R1, p1), CAP_A[0], CAP_A[1], T(R2, p2), jnp.asarray(HALF)),
        in_axes=(2, 1, 2, 1))
    return tuple(jnp.moveaxis(x, 0, -1) for x in one(Ra, pa, Rb, pb))


KINDS = {
    "sphere_sphere": (
        lambda Ra, pa, Rb, pb: jc.sphere_sphere_b(pa, R_A, pb, R_B),
        lambda Ra, pa, Rb, pb: tc.sphere_sphere_b(pa, _c(R_A), pb, _c(R_B))),
    "sphere_box": (
        lambda Ra, pa, Rb, pb: jc.sphere_box_b(pa, R_A, Rb, pb, HALF),
        lambda Ra, pa, Rb, pb: tc.sphere_box_b(pa, _c(R_A), Rb, pb, _c(HALF))),
    "capsule_sphere": (
        lambda Ra, pa, Rb, pb: jc.capsule_sphere_b(Ra, pa, *CAP_A, pb, R_B),
        lambda Ra, pa, Rb, pb: tc.capsule_sphere_b(Ra, pa, _c(CAP_A[0]), _c(CAP_A[1]),
                                                   pb, _c(R_B))),
    "capsule_capsule": (
        lambda Ra, pa, Rb, pb: jc.capsule_capsule_b(Ra, pa, *CAP_A, Rb, pb, *CAP_B),
        lambda Ra, pa, Rb, pb: tc.capsule_capsule_b(
            Ra, pa, _c(CAP_A[0]), _c(CAP_A[1]), Rb, pb, _c(CAP_B[0]), _c(CAP_B[1]))),
    "capsule_box": (
        _capsule_box_jax,
        lambda Ra, pa, Rb, pb: tc.capsule_box_b(Ra, pa, _c(CAP_A[0]), _c(CAP_A[1]),
                                                Rb, pb, _c(HALF))),
}


@pytest.mark.parametrize("gap", [-0.1, 0.3], ids=["touching", "apart"])
@pytest.mark.parametrize("kind", KINDS)
def test_pair_kinds_match_jax(kind, gap):
    """Points, normals and depths of each sphere/capsule kind against the
    JAX package's (jax.jit), from seeded poses, to 1e-12; touching, every
    world has a contact of positive depth, apart, none."""
    Ra, pa, Rb, pb = _pose(sorted(KINDS).index(kind), gap)
    jf, tf = KINDS[kind]
    want = jax.jit(jf)(*map(jnp.asarray, (Ra, pa, Rb, pb)))
    got = tf(t64(Ra)[None], t64(pa)[None], t64(Rb)[None], t64(pb)[None])
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-12)
    deepest = n(got[2]).max(axis=0)
    assert (deepest > 0).all() if gap < 0 else (deepest < 0).all()


def _shapes_world(cap_box):
    """Five free bodies, no gravity: two spheres, a box and two capsules,
    every pair colliding (sphere-sphere, sphere-box, capsule-sphere,
    capsule-capsule, and with cap_box capsule-box; without it those pairs
    are filtered off). JAX package world."""
    from nimblephysics_tpu.dynamics import FREE

    w = World(gravity=(0.0, 0.0, 0.0))
    shapes = [ShapeSpec("sphere", np.array([R_A])), ShapeSpec("sphere", np.array([R_B])),
              ShapeSpec("box", 2 * HALF), ShapeSpec("capsule", np.array(CAP_A)),
              ShapeSpec("capsule", np.array(CAP_B))]
    for i, sh in enumerate(shapes):
        sk = Skeleton(f"body{i}")
        sk.add_joint_and_body(FREE, name=f"body{i}", shapes=(sh,))
        w.add_skeleton(sk)
    if not cap_box:
        w.collision_overrides[(2, 3)] = w.collision_overrides[(2, 4)] = False
    return w


def _shapes_state(seed):
    """The five bodies in a 0.25 m cluster, rotated, moving toward its
    centre: (30, 3) q and v."""
    rng = np.random.RandomState(seed)
    q = np.zeros((30, 3))
    for i in range(5):
        q[6 * i:6 * i + 3] = rng.randn(3, 3)
        q[6 * i + 3:6 * i + 6] = 0.25 * rng.rand(3, 3)
    v = np.zeros_like(q)
    v[3::6] = v[4::6] = v[5::6] = -0.5 * (q[3::6] + q[4::6] + q[5::6]) / 3
    return q, v


def test_pair_kind_world_collides_as_jax_and_steps():
    """The world of every sphere/capsule kind but capsule-box: the
    collider's slots and every contact against the JAX package's batched
    collider (jax.jit, fed the port's body poses: fk is held elsewhere);
    with the capsule-box pairs too (3 slots each, as the plan says): the
    port's engine steps it, every row's impulse finite and some contact
    loaded."""
    jw = _shapes_world(cap_box=False)
    tw = world_from_arrays(dump_world(jw))
    jcol, tcol = JaxCollider(JaxPlan(jw)), BatchedCollider(Collider(tw))
    assert [(s.kind, s.n_slots) for s in tcol.slots] == [
        (s.kind, s.n_slots) for s in jcol.slots]
    assert {s.kind for s in tcol.slots} == set(KINDS) - {"capsule_box"}
    q, v = _shapes_state(21)
    tR, tp, *_ = ta.fk(ta.FlatWorld(tw), t64(q))
    want = jax.jit(lambda R, p: jcol.collide(R, p, 3))(
        [jnp.asarray(n(x)) for x in tR], [jnp.asarray(n(x)) for x in tp])
    got = tcol.collide(tR, tp, 3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-12)
    assert (n(got[2]) > 0).any()
    from nimblephysics_tpu_torch.batched import BatchedEngine

    full = world_from_arrays(dump_world(_shapes_world(cap_box=True)))
    eng = BatchedEngine(full, device="cpu", dtype=torch.float64)
    kinds = [s.kind for s in eng.bcollider.slots]
    assert kinds.count("capsule_box") == 2 and eng.bcollider.num_contacts == 14
    r = eng.step(t64(q), t64(v), t64(np.zeros_like(q)))
    assert bool(torch.isfinite(r.impulses).all()) and float(r.impulses.abs().max()) > 1e-4
    assert r.impulses.shape == (3 * 14, 3)

"""nimblephysics_tpu_torch's heightmaps and sphere sets, raycasts,
distances and the world carry-across, against the JAX package, float64
on the CPU.

* the heightmap kinds (sphere, capsule, box) against the JAX
  narrowphase's functions to 1e-12 over seeded poses, and the float32
  sample at the grid's last row and column (the clip to W - 1 - 1e-9
  rounds to W - 1, so the last cell takes fx = 1), bit for bit;
* every heightmap and sphere-set kind (the six multisphere kinds, with
  the box one's normal flipped to point from the set to the box) in one
  world, the single-world and the batched collider against the JAX ones
  to 1e-12, and their slot plans;
* single-world steps on tests/test_terrain.py's worlds against the JAX
  Engine: q and v to 1e-9, impulses by close_impulses;
* the batched step of the half-cheetah on a heightmap (B = 4) against
  the JAX BatchedEngine; a VJP through a heightmap contact against
  finite differences;
* raycast and distance on tests/test_extras.py's worlds;
* world_from_arrays carrying every new joint type and shape across: the
  specs against the JAX world's, and the step of the carried world
  against the same world built with the port's own API, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nimblephysics_tpu as jpkg
import nimblephysics_tpu.math.splines  # noqa: F401  (jpkg.math.splines)
import nimblephysics_tpu.models  # noqa: F401
import nimblephysics_tpu.simulation.world  # noqa: F401
import nimblephysics_tpu_torch as tpkg
import nimblephysics_tpu_torch.models  # noqa: F401
from nimblephysics_tpu.batched import BatchedEngine as JaxBatched
from nimblephysics_tpu.batched import articulated as ja
from nimblephysics_tpu.batched.collision import BatchedCollider as JaxBatchedCollider
from nimblephysics_tpu.collision import distance as jdistance
from nimblephysics_tpu.collision import narrowphase as jn
from nimblephysics_tpu.collision import raycast as jraycast
from nimblephysics_tpu.collision.collider import Collider as JaxCollider
from nimblephysics_tpu.neural.timestep import Engine as JaxEngine

from nimblephysics_tpu_torch.batched import BatchedEngine
from nimblephysics_tpu_torch.batched import articulated as ta
from nimblephysics_tpu_torch.batched import collision as tc
from nimblephysics_tpu_torch.batched.collision import BatchedCollider
from nimblephysics_tpu_torch.collision import distance, narrowphase as tn, raycast
from nimblephysics_tpu_torch.collision.collider import Collider
from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.neural import Engine
from test_torch_timestep import close_impulses
from torch_parity import F64, dump_world, n, t64

HEIGHTS = 0.05 * np.random.RandomState(0).randn(6, 7)
SCALE = (0.5, 0.4, 1.0)


def _T(R, p):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, p
    return T


def _rot(w):
    return n(ta.bl.exp_so3(t64(np.asarray(w, np.float64)[:, None])))[..., 0]


HM_KINDS = {
    "sphere": (lambda Ta, Tb, hm: jn.sphere_heightmap(Ta[:3, 3], 0.1, Tb, hm, SCALE),
               lambda Ta, Tb, hm: tn.sphere_heightmap(Ta[:3, 3], 0.1, Tb, hm, SCALE)),
    "capsule": (lambda Ta, Tb, hm: jn.capsule_heightmap(Ta, 0.05, 0.3, Tb, hm, SCALE),
                lambda Ta, Tb, hm: tn.capsule_heightmap(Ta, 0.05, 0.3, Tb, hm, SCALE)),
    "box": (lambda Ta, Tb, hm: jn.box_heightmap(Ta, jnp.asarray([0.1, 0.15, 0.05]), Tb, hm,
                                                SCALE),
            lambda Ta, Tb, hm: tn.box_heightmap(Ta, t64([0.1, 0.15, 0.05]), Tb, hm, SCALE)),
}


@pytest.mark.parametrize("kind", HM_KINDS)
def test_heightmap_kinds_match_jax(kind):
    """Seeded poses over a tilted heightmap, some over the grid's edge:
    points, normals and depths of every slot to 1e-12."""
    rng = np.random.RandomState(1)
    jf, tf = HM_KINDS[kind]
    Tb = _T(_rot([0.1, -0.2, 0.3]), [0.05, -0.02, 0.01])
    deep = off = False
    for _ in range(6):
        Ta = _T(_rot(0.5 * rng.randn(3)), [*(0.9 * rng.randn(2)), 0.05 * rng.randn()])
        want = jf(jnp.asarray(Ta), jnp.asarray(Tb), jnp.asarray(HEIGHTS))
        got = tf(t64(Ta), t64(Tb), t64(HEIGHTS))
        for a, b in zip(got, want):
            np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-12, rtol=0)
        deep |= bool((np.asarray(want[2]) > 0).any())
        off |= bool((np.asarray(want[2]) == -1.0).any())
    assert deep and off, "the poses must reach contact and leave the grid"


def test_float32_sample_at_the_last_row_and_column_matches_jax():
    """Points on the grid's last column and row in float32 (spacing a
    power of 2, so that x / sx and x * (1 / sx) agree): the clipped grid
    coordinate rounds to W - 1, the last cell takes fx = 1 and the
    height is the last column's, in both packages alike."""
    H, W = HEIGHTS.shape
    hm32 = HEIGHTS.astype(np.float32)
    scale = (0.5, 0.25, 1.0)
    xs = np.array([(W - 1) / 2 * 0.5, (W - 1) / 2 * 0.5, 0.1, -(W - 1) / 2 * 0.5], np.float32)
    ys = np.array([0.05, (H - 1) / 2 * 0.25, (H - 1) / 2 * 0.25, 0.0], np.float32)
    hm = tc.Heightmap.of(torch.as_tensor(hm32), scale)
    h, nrm, inside = tc._heightmap_sample(hm, torch.as_tensor(xs), torch.as_tensor(ys))
    for i in range(len(xs)):
        jh, jnrm, jin = jn._heightmap_sample(jnp.asarray(hm32), scale,
                                             jnp.asarray([xs[i], ys[i]]))
        assert h.dtype == torch.float32 and np.asarray(jh).dtype == np.float32
        np.testing.assert_array_equal(n(h)[i], np.asarray(jh))
        np.testing.assert_allclose(n(nrm)[:, i], np.asarray(jnrm), rtol=2e-7, atol=0)
        assert bool(inside[i]) == bool(jin)
    assert bool(inside[0]) and bool(inside[1])


def _zoo_world(pkg):
    """A world holding every heightmap and sphere-set kind, built with
    either package's API: a ground plane and a heightmap (static), a
    dumbbell sphere set over each, a sphere, a capsule and a box next to
    the first dumbbell."""
    D = pkg.dynamics
    w = pkg.simulation.World(gravity=(0.0, 0.0, -9.81), time_step=1e-3)

    def body(name, shape, joint=D.FREE):
        sk = D.Skeleton(name)
        sk.add_joint_and_body(joint, parent=-1, name=name, mass=1.0,
                              inertia=np.eye(3) * 0.01, shapes=(shape,))
        w.add_skeleton(sk)

    body("ground", D.ShapeSpec("plane", np.array([0.0, 0.0, 1.0, 0.0]), friction=0.7,
                               restitution=0.5), D.WELD)
    body("terrain", D.ShapeSpec("heightmap", np.asarray(SCALE), friction=0.8,
                                T_offset=_T(np.eye(3), [0.6, 0.0, 0.0]), heights=HEIGHTS),
         D.WELD)
    dumbbell = np.array([[-0.15, 0.0, 0.0, 0.08], [0.15, 0.0, 0.02, 0.06]])
    body("ms_a", D.ShapeSpec("multisphere", np.zeros(1), spheres=dumbbell,
                             T_offset=_T(_rot([0.0, 0.0, 0.3]), [0.0, 0.01, 0.0])))
    body("ms_b", D.ShapeSpec("multisphere", np.zeros(1), spheres=dumbbell[::-1], friction=0.6))
    body("ball", D.ShapeSpec("sphere", np.array([0.07]), restitution=0.3))
    body("rod", D.ShapeSpec("capsule", np.array([0.04, 0.2])))
    body("brick", D.ShapeSpec("box", np.array([0.12, 0.1, 0.08])))
    return w


# Per free body (ms_a, ms_b, ball, rod, brick): [rotation; x, y, z]. The
# dumbbells rest on the plane, ms_b over the heightmap too and against
# ms_a; the others sit around ms_a.
ZOO_Q = np.array([
    [0.0, 0.1, 0.0, 0.0, 0.0, 0.075],
    [0.05, 0.0, 0.1, 0.32, 0.0, 0.075],
    [0.0, 0.0, 0.0, 0.05, 0.13, 0.09],
    [0.3, 1.2, 0.0, -0.05, -0.12, 0.1],
    [0.1, 0.0, 0.2, 0.25, 0.02, 0.06],
]).reshape(-1)
ZOO_KINDS = ["sphere_heightmap", "capsule_heightmap", "box_heightmap", "multisphere_plane",
             "sphere_multisphere", "capsule_multisphere", "box_multisphere",
             "multisphere_multisphere", "multisphere_heightmap"]


@pytest.fixture(scope="module")
def zoo():
    jw = _zoo_world(jpkg)
    tw = world_from_arrays(dump_world(jw))
    jc, tcol = JaxCollider(jw), Collider(tw)
    return jw, tw, jc, tcol, jc.collide(jnp.asarray(ZOO_Q)), tcol.collide(t64(ZOO_Q))


def test_zoo_slot_plans_match_jax(zoo):
    jw, tw, jc, tcol, _, _ = zoo
    assert [(s.kind, s.body_a, s.body_b, s.n_slots) for s in tcol.slots] == [
        (s.kind, s.body_a, s.body_b, s.n_slots) for s in jc.slots]
    assert {s.kind for s in jc.slots} >= set(ZOO_KINDS)
    jb, tb = JaxBatchedCollider(jc), BatchedCollider(tcol)
    for f in ("body_a", "body_b", "mu", "restitution"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))


@pytest.mark.parametrize("kind", ZOO_KINDS)
def test_zoo_kind_matches_jax(zoo, kind):
    """Each kind's slots of the single-world contact set to 1e-12."""
    _, _, jc, _, want, got = zoo
    first = np.cumsum([0] + [s.n_slots for s in jc.slots])
    rows = np.concatenate([np.arange(first[i], first[i + 1])
                           for i, s in enumerate(jc.slots) if s.kind == kind])
    for f in ("point", "normal", "depth"):
        np.testing.assert_allclose(n(getattr(got, f))[rows], np.asarray(getattr(want, f))[rows],
                                   atol=1e-12, rtol=0)
    if kind not in ("sphere_heightmap", "capsule_heightmap", "box_heightmap"):
        assert (np.asarray(want.depth)[rows] > 0).any(), "the kind must touch"


def test_zoo_batched_collide_matches_jax(zoo):
    """The port's batched collider at B = 4 against the JAX single-world
    collider world by world (the JAX batched collider's capsule_box_b
    returns 2 contacts for the plan's 3)."""
    jw, tw, jc, tcol, _, _ = zoo
    q = ZOO_Q[:, None] + 0.005 * np.random.RandomState(2).randn(len(ZOO_Q), 4)
    tR, tp, *_ = ta.fk(ta.FlatWorld(tw), t64(q))
    got = BatchedCollider(tcol).collide(tR, tp, 4)
    for b in range(4):
        want = jc.collide(jnp.asarray(q[:, b]))
        for a, w in zip(got, (want.point, want.normal, want.depth)):
            np.testing.assert_allclose(n(a)[..., b], np.asarray(w), atol=1e-12, rtol=0)


def _terrain_world(pkg, heights, scale=(0.5, 0.5, 1.0), shape=None):
    """tests/test_terrain.py's _terrain_world, with either package."""
    D = pkg.dynamics
    w = pkg.simulation.World(gravity=(0.0, 0.0, -9.81), time_step=0.001)
    ground = D.Skeleton("terrain")
    ground.add_joint_and_body(D.WELD, parent=-1, name="hm", mass=1.0, shapes=(
        D.ShapeSpec("heightmap", np.asarray(scale), friction=0.8,
                    heights=np.asarray(heights, dtype=np.float64)),))
    w.add_skeleton(ground)
    ball = D.Skeleton("ball")
    ball.add_joint_and_body(D.FREE, parent=-1, name="ball", mass=1.0, inertia=np.eye(3) * 0.004,
                            shapes=(shape or D.ShapeSpec("sphere", np.array([0.1]),
                                                         friction=0.8),))
    w.add_skeleton(ball)
    return w


SLOPE = np.tile(0.3 * np.linspace(-1, 1, 9), (9, 1))


def _step_case(name):
    """(JAX world, q, v) of tests/test_terrain.py's worlds, in contact."""
    D = jpkg.dynamics
    q, v = np.zeros(6), np.zeros(6)
    if name == "flat":
        w = _terrain_world(jpkg, np.full((5, 5), 0.2))
        q[5], v[:3] = 0.299, [0.3, -0.2, 0.1]
    elif name == "slope":
        w = _terrain_world(jpkg, SLOPE, scale=(0.25, 0.25, 1.0))
        q[3], q[5] = 0.1, 0.03 + 0.1 * np.sqrt(1.09) - 1e-3
    elif name == "rough":
        w = _terrain_world(jpkg, 0.05 * np.random.RandomState(0).randn(6, 6))
        q[5], v[5] = float(w.skeletons[0].bodies[0].shapes[0].heights[2:4, 2:4].mean()) + 0.098, -0.3
    else:  # tests/test_terrain.py's dumbbell on a plane
        w = jpkg.simulation.World(gravity=(0.0, 0.0, -9.81), time_step=0.001)
        g = D.Skeleton("ground")
        g.add_joint_and_body(D.WELD, parent=-1, name="plane", mass=1.0, shapes=(
            D.ShapeSpec("plane", np.array([0.0, 0.0, 1.0, 0.0])),))
        w.add_skeleton(g)
        b = D.Skeleton("dumbbell")
        b.add_joint_and_body(D.FREE, parent=-1, name="db", mass=1.0, inertia=np.eye(3) * 0.01,
                             shapes=(D.ShapeSpec("multisphere", np.zeros(1), spheres=np.array(
                                 [[-0.15, 0.0, 0.0, 0.08], [0.15, 0.0, 0.0, 0.08]])),))
        w.add_skeleton(b)
        q[1], q[5] = 0.05, 0.079
    return w, q, v


@pytest.mark.parametrize("name", ["flat", "slope", "rough", "multisphere_plane"])
def test_single_world_steps_match_jax(name):
    jw, q, v = _step_case(name)
    tw = world_from_arrays(dump_world(jw))
    je, te = JaxEngine(jw), Engine(tw, device="cpu")
    f = jax.jit(lambda q, v, u, z: je.step(q, v, u, z_warm=z))
    u, z = np.zeros(6), np.zeros(je.num_constraint_rows)
    tq, tv, tz = t64(q), t64(v), t64(z)
    for _ in range(2):
        r = f(q, v, u, z)
        s = te.step(tq, tv, t64(u), z_warm=tz)
        np.testing.assert_allclose(n(s.q), np.asarray(r.q), atol=1e-9, rtol=0)
        np.testing.assert_allclose(n(s.v), np.asarray(r.v), atol=1e-9, rtol=0)
        close_impulses(s.impulses, r.impulses, te.lcp_problem(tq, tv, t64(u)).F.numpy())
        assert np.abs(np.asarray(r.impulses)).max() > 0, "the step must carry impulses"
        q, v, z = np.asarray(r.q), np.asarray(r.v), np.asarray(r.impulses)
        tq, tv, tz = s.q, s.v, s.impulses


def _terrain_cheetah(pkg):
    """The half-cheetah with its ground plane replaced by a 17 x 17 point
    heightmap of 0.1 m and heights up to 3 cm, local +z on the world's +y
    (chip_smoke.terrain_cheetah's construction, on a smaller grid)."""
    world, q0, _ = pkg.models.half_cheetah()
    old = world.skeletons[0]
    plane = old.bodies[0].shapes[0]
    T = np.eye(4)
    T[:3, :3] = [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]]
    T[1, 3] = float(plane.size[3])
    ground = pkg.dynamics.Skeleton("ground")
    ground.add_joint_and_body(
        pkg.dynamics.WELD, parent=-1, name="ground", T_pj=old.joints[0].T_pj, mass=1.0,
        shapes=(pkg.dynamics.ShapeSpec(
            "heightmap", np.array([0.1, 0.1, 1.0]), T_offset=T, friction=plane.friction,
            heights=0.03 * np.random.RandomState(22).rand(17, 17)),))
    world.skeletons[0] = ground
    return world, np.asarray(q0, np.float64)


def test_terrain_half_cheetah_batched_step_matches_jax():
    """B = 4, SolverConfig.throughput(), feet in the terrain: q to 1e-10,
    v to 1e-9, each world's impulses by close_impulses on its F, depths
    to 1e-12."""
    jw, q0 = _terrain_cheetah(jpkg)
    jw.solver = jpkg.simulation.world.SolverConfig.throughput()
    tw = world_from_arrays(dump_world(jw))
    rng = np.random.RandomState(7)
    q = np.tile(q0[:, None], (1, 4)) + 0.03 * rng.randn(9, 4)
    q[1] -= 0.25
    v, u = 0.3 * rng.randn(9, 4), 0.3 * rng.randn(9, 4)
    je = JaxBatched(jw)
    jr = jax.jit(lambda q, v, u: je.step(q, v, u))(jnp.asarray(q), jnp.asarray(v),
                                                   jnp.asarray(u))
    tr = BatchedEngine(tw, **F64).step(t64(q), t64(v), t64(u))
    assert [s.kind for s in Collider(tw).slots] == ["capsule_heightmap"] * 8
    np.testing.assert_allclose(n(tr.contact_depths), np.asarray(jr.contact_depths), atol=1e-12)
    np.testing.assert_allclose(n(tr.q), np.asarray(jr.q), atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(n(tr.v), np.asarray(jr.v), atol=1e-9, rtol=1e-9)
    F = n(BatchedEngine(tw, **F64).lcp_problem(t64(q), t64(v), t64(u)).F)
    for w in range(4):
        close_impulses(tr.impulses[:, w], np.asarray(jr.impulses)[:, w], F[..., w])
    assert np.abs(np.asarray(jr.impulses)).max() > 0


def test_heightmap_contact_vjp_matches_finite_differences():
    """w^T d[q'; v']/d[q; v] of the single-world step of a sphere 2 mm
    into a rough heightmap (live impulses), one reverse pass, against the
    port's Ridders finite differences of the step (a fixed central step
    below 1e-5 meets the pinned solve's amplified roundoff)."""
    from nimblephysics_tpu_torch.math import finite_difference_jacobian

    jw, q, v = _step_case("rough")
    te = Engine(world_from_arrays(dump_world(jw)), device="cpu")
    w = np.random.RandomState(9).randn(12)
    u = t64(np.zeros(6))

    def step(x):
        r = te.step(x[:6], x[6:], u)
        return torch.cat([r.q, r.v])

    x0 = np.concatenate([q, v])
    x = t64(x0).requires_grad_()
    out = step(x)
    assert float(out.new_tensor(n(te.step(x[:6], x[6:], u).impulses)).abs().max()) > 0
    (g,) = torch.autograd.grad(torch.dot(t64(w), out), x)
    with torch.no_grad():
        J = finite_difference_jacobian(lambda y: n(step(t64(y))), x0)
    np.testing.assert_allclose(n(g), w @ J, atol=1e-8, rtol=1e-8)


def _sphere_ground(pkg, radius):
    D = pkg.dynamics
    w = pkg.simulation.World()
    s = D.Skeleton("sphere")
    s.add_joint_and_body(D.FREE, parent=-1, name="sphere", mass=1.0,
                         inertia=np.eye(3) * 0.4 * radius**2,
                         shapes=(D.ShapeSpec("sphere", np.array([radius])),))
    w.add_skeleton(s)
    g = D.Skeleton("ground")
    g.add_joint_and_body(D.WELD, parent=-1, name="ground", mass=1.0, shapes=(
        D.ShapeSpec("plane", np.array([0.0, 0.0, 1.0, 0.0]), restitution=1.0),))
    w.add_skeleton(g)
    return w


RAYS = {  # tests/test_extras.py's TestRaycast rays, and a capsule one
    "hits_sphere": ((0.0, 0.0, 3.0), (0.0, 0.0, -1.0)),
    "hits_ground": ((5.0, 0.0, 2.0), (0.0, 0.0, -1.0)),
    "miss": ((0.0, 0.0, 3.0), (0.0, 0.0, 1.0)),
    "slanted": ((1.0, 0.5, 2.0), (-0.4, -0.2, -1.0)),
}


@pytest.mark.parametrize("ray", RAYS)
def test_raycast_matches_jax(ray):
    jw = _sphere_ground(jpkg, 0.2)
    tw = world_from_arrays(dump_world(jw))
    q = np.zeros(6)
    q[5] = 1.0
    o, d = (np.asarray(x, np.float64) for x in RAYS[ray])
    jh = jraycast(jw, jnp.asarray(q), jnp.asarray(o), jnp.asarray(d))
    th = raycast(tw, t64(q), t64(o), t64(d))
    assert bool(th.hit) == bool(jh.hit) and int(th.body) == int(jh.body)
    for a, b in zip(th[1:4], jh[1:4]):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-12, rtol=0)


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_raycast_box_and_capsule_match_jax(shape):
    """tests/test_extras.py's box ray, and the same ray at a capsule
    turned about y."""
    D = jpkg.dynamics
    jw = jpkg.simulation.World()
    sk = D.Skeleton(shape)
    spec = (D.ShapeSpec("box", np.array([0.4, 0.4, 0.4])) if shape == "box"
            else D.ShapeSpec("capsule", np.array([0.1, 0.4]), T_offset=_T(_rot([0, 1.2, 0]), 0)))
    sk.add_joint_and_body(D.FREE, parent=-1, name=shape, mass=1.0, shapes=(spec,))
    jw.add_skeleton(sk)
    tw = world_from_arrays(dump_world(jw))
    q, o, d = np.zeros(6), np.array([2.0, 0.05, 0.05]), np.array([-1.0, 0.0, 0.0])
    jh = jraycast(jw, jnp.asarray(q), jnp.asarray(o), jnp.asarray(d))
    th = raycast(tw, t64(q), t64(o), t64(d))
    assert bool(th.hit) and bool(jh.hit)
    for a, b in zip(th[1:4], jh[1:4]):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-12, rtol=0)


def test_distance_matches_jax():
    """tests/test_extras.py's TestDistance: the signed distance 0.4 above
    the ground, its nearest slot, and d(dist)/dq against jax.grad."""
    jw = _sphere_ground(jpkg, 0.1)
    tw = world_from_arrays(dump_world(jw))
    q = np.zeros(6)
    q[5] = 0.5
    jr = jdistance(jw, jnp.asarray(q))
    x = t64(q).requires_grad_()
    tr = distance(tw, x)
    np.testing.assert_allclose(float(tr.min_distance), float(jr.min_distance), atol=1e-12)
    np.testing.assert_allclose(n(tr.point), np.asarray(jr.point), atol=1e-12)
    np.testing.assert_allclose(n(tr.normal), np.asarray(jr.normal), atol=1e-12)
    assert int(tr.pair_index) == int(jr.pair_index)
    (g,) = torch.autograd.grad(tr.min_distance, x)
    jg = jax.grad(lambda qq: jdistance(jw, qq).min_distance)(jnp.asarray(q))
    np.testing.assert_allclose(n(g), np.asarray(jg), atol=1e-12)
    np.testing.assert_allclose(n(tpkg.collision.pairwise_distances(tw, t64(q))),
                               np.asarray(jpkg.collision.pairwise_distances(jw, jnp.asarray(q))),
                               atol=1e-12)


def _carry_world(pkg):
    """A world with every new joint type (custom, ellipsoid,
    scapulathoracic, constantcurve, constantcurveincompressible) and
    every new shape (mesh, heightmap, multisphere), with either package."""
    D, S = pkg.dynamics, pkg.math.splines
    w = _zoo_world(pkg)
    xs = np.linspace(-1.5, 1.5, 7)
    cj = D.joints.CustomJointDef(
        n_dofs=2, rot_axes=np.eye(3), trans_axes=np.eye(3),
        functions=(S.linear(1.0, 0.0), S.simm_spline(xs, 0.3 * np.sin(xs)), S.constant(0.0),
                   S.multiplier(S.polynomial([0.2, 0.0, 0.1]), 0.5), S.constant(0.05),
                   S.constant(0.0)),
        drives=(0, 1, -1, 1, -1, -1))
    sk = D.Skeleton("osim")
    a = sk.add_joint_and_body("custom", parent=-1, name="seg", custom=cj, mass=1.1,
                              inertia=np.eye(3) * 0.02)
    props = {"ellipsoid": {"radii": (0.07, 0.05, 0.09), "flip": (1.0, -1.0, 1.0)},
             "scapulathoracic": {"radii": (0.07, 0.05, 0.09), "euler_order": "zyx",
                                 "winging_axis_offset": (0.02, -0.01),
                                 "winging_axis_direction": 0.4},
             "constantcurve": {"neutral": (0.0, 0.0, 0.0, 0.3)},
             "constantcurveincompressible": {"length": 0.35, "neutral": (0.05, 0.0, -0.02)}}
    for jt, pr in props.items():
        a = sk.add_joint_and_body(jt, parent=a, name=jt, props=pr, mass=0.5,
                                  com=(0.0, 0.05, 0.0), inertia=np.eye(3) * 0.01)
    w.add_skeleton(sk)
    rock = D.Skeleton("rock")
    rock.add_joint_and_body(D.FREE, parent=-1, name="rock", mass=1.0, inertia=np.eye(3) * 0.01,
                            shapes=(D.ShapeSpec("mesh", np.zeros(1), mesh_vertices=0.1 *
                                                np.random.RandomState(5).randn(10, 3)),))
    w.add_skeleton(rock)
    return w


def test_world_from_arrays_carries_every_new_joint_and_shape():
    jw = _carry_world(jpkg)
    carried = world_from_arrays(dump_world(jw))
    direct = _carry_world(tpkg)
    for js, ts in zip(jw.skeletons, carried.skeletons):
        for jj, tj in zip(js.joints, ts.joints):
            assert (tj.joint_type, tj.num_dofs, tj.props) == (jj.joint_type, jj.num_dofs,
                                                              jj.props)
            if jj.custom is not None:
                assert tj.custom.drives == jj.custom.drives
                np.testing.assert_array_equal(tj.custom.rot_axes, jj.custom.rot_axes)
                for tf, jf in zip(tj.custom.functions, jj.custom.functions):
                    assert (tf.kind, tf.scale) == (jf.kind, jf.scale)
                    for tp, jp in zip(tf.params, jf.params):
                        np.testing.assert_array_equal(tp, jp)
        for jb, tb in zip(js.bodies, ts.bodies):
            for jsh, tsh in zip(jb.shapes, tb.shapes):
                for f in ("mesh_vertices", "heights", "spheres"):
                    a, b = getattr(jsh, f), getattr(tsh, f)
                    assert (a is None) == (b is None)
                    if a is not None:
                        np.testing.assert_array_equal(b, a)
    nv = carried.num_dofs
    assert nv == jw.num_dofs == direct.num_dofs == 30 + 2 + 3 + 4 + 4 + 3 + 6
    rng = np.random.RandomState(13)
    q = np.concatenate([ZOO_Q, 0.3 * rng.randn(16), np.array([0, 0, 0, 0.6, 0.0, 0.12])])
    x = [t64(q[:, None]), t64(0.2 * rng.randn(nv, 1)), t64(0.1 * rng.randn(nv, 1))]
    a = BatchedEngine(carried, **F64).step(*x)
    b = BatchedEngine(direct, **F64).step(*x)
    for f in ("q", "v", "impulses"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert float(a.impulses.abs().max()) > 0

"""nimblephysics_tpu_torch's convex-mesh collision against the JAX
package's collision/convex.py, float64 on the CPU.

* the plan-time hull (decimation, face planes, ConvexHull.build,
  hull_triangles) bit for bit;
* the five mesh pair kinds (mesh_plane, sphere_mesh, capsule_mesh,
  box_mesh, mesh_mesh): points, normals and depths slot by slot to 1e-12
  over seeded poses, and with ties (a cube flat on a plane or a box: four
  equal depths, which keep the lower index first, as jax.lax.top_k does);
* the slot plans of both colliders and the batched collider (B = 4) on
  tests/test_mesh_collision.py's worlds;
* single-world steps on those worlds against the JAX Engine: q and v to
  1e-9, impulses by test_torch_timestep.close_impulses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nimblephysics_tpu.batched import articulated as ja
from nimblephysics_tpu.batched.collision import BatchedCollider as JaxBatchedCollider
from nimblephysics_tpu.collision import convex as jcv
from nimblephysics_tpu.collision.collider import Collider as JaxCollider
from nimblephysics_tpu.dynamics import FREE, WELD, ShapeSpec, Skeleton
from nimblephysics_tpu.neural.timestep import Engine as JaxEngine
from nimblephysics_tpu.simulation.world import World

from nimblephysics_tpu_torch.batched import articulated as ta
from nimblephysics_tpu_torch.batched.collision import BatchedCollider
from nimblephysics_tpu_torch.collision import convex as tcv
from nimblephysics_tpu_torch.collision import narrowphase as tn
from nimblephysics_tpu_torch.collision.collider import Collider
from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.neural import Engine
from test_torch_timestep import close_impulses
from torch_parity import dump_world, n, t64


def _octahedron(r=0.1):
    return r * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                         [0, 0, -1]], dtype=np.float64)


def _cube_verts(h=0.1):
    return np.array([[sx, sy, sz] for sx in (-h, h) for sy in (-h, h) for sz in (-h, h)])


CLOUDS = {
    "cube": _cube_verts(),
    "octahedron": _octahedron(),
    "cloud500": 0.1 * np.random.RandomState(0).randn(500, 3),
    "cloud12": 0.1 * np.random.RandomState(1).randn(12, 3),
}


@pytest.mark.parametrize("name", CLOUDS)
def test_hull_build_is_bit_equal(name):
    v = CLOUDS[name]
    np.testing.assert_array_equal(tcv.decimate_support(v), jcv.decimate_support(v))
    jh, th = jcv.ConvexHull.build(v), tcv.ConvexHull.build(v)
    for f in ("verts", "face_n", "face_d"):
        np.testing.assert_array_equal(getattr(th, f), getattr(jh, f))
    np.testing.assert_array_equal(tcv.hull_triangles(th.verts), jcv.hull_triangles(jh.verts))
    np.testing.assert_array_equal(tcv.hull_faces(th.verts)[0], jcv.hull_faces(jh.verts)[0])


HULLS = {k: (jcv.ConvexHull.build(v), tcv.ConvexHull.build(v))
         for k, v in CLOUDS.items() if k != "cloud500"}


def _T(R, p):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, p
    return T


def _rot(w):
    return n(ta.bl.exp_so3(t64(np.asarray(w, np.float64)[:, None])))[..., 0]


def _poses(seed, k=4):
    """k seeded pose pairs: A near the origin, B within ~0.15 of it."""
    rng = np.random.RandomState(seed)
    return [(_T(_rot(rng.randn(3)), 0.02 * rng.randn(3)),
             _T(_rot(rng.randn(3)), 0.12 * rng.randn(3))) for _ in range(k)]


def _pair(kind, hull, Ta, Tb):
    """(JAX outputs, port outputs) of one pair kind at poses Ta, Tb: the
    mesh is `hull`, the other shape a unit-ish primitive (sphere 0.1,
    capsule (0.05, 0.2), box half sizes (0.08, 0.07, 0.06), the plane
    z = -0.05 turned by Tb's rotation, mesh_mesh's B the octahedron)."""
    jh, th = HULLS[hull]
    jTa, jTb, tTa, tTb = jnp.asarray(Ta), jnp.asarray(Tb), t64(Ta), t64(Tb)
    half = np.array([0.08, 0.07, 0.06])
    if kind == "mesh_plane":
        nrm = Tb[:3, :3] @ np.array([0.0, 0.0, 1.0])
        return (jcv.mesh_plane(jTa, jh, jnp.asarray(nrm), -0.05),
                tn.mesh_plane(tTa, th, t64(nrm), -0.05))
    if kind == "sphere_mesh":
        return (jcv.sphere_mesh(jTa[:3, 3], 0.1, jTb, jh),
                tn.sphere_mesh(tTa[:3, 3], 0.1, tTb, th))
    if kind == "capsule_mesh":
        return (jcv.capsule_mesh(jTa, 0.05, 0.2, jTb, jh),
                tn.capsule_mesh(tTa, 0.05, 0.2, tTb, th))
    if kind == "box_mesh":
        return (jcv.box_mesh(jTa, jnp.asarray(half), jTb, jh),
                tn.box_mesh(tTa, t64(half), tTb, th))
    jo, to = HULLS["octahedron"]
    return (jcv.mesh_mesh(jTa, jh, jTb, jo), tn.mesh_mesh(tTa, th, tTb, to))


def _same(got, want):
    for a, b in zip(got, want):
        assert n(a).shape == np.asarray(b).shape
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-12, rtol=0)


MESH_KINDS = ["mesh_plane", "sphere_mesh", "capsule_mesh", "box_mesh", "mesh_mesh"]


@pytest.mark.parametrize("hull", list(HULLS))
@pytest.mark.parametrize("kind", MESH_KINDS)
def test_mesh_pair_kinds_match_jax(kind, hull):
    deep = False
    for Ta, Tb in _poses(7):
        want, got = _pair(kind, hull, Ta, Tb)
        _same(got, want)
        deep |= bool((np.asarray(want[2]) > 0).any())
    assert deep, "the poses must put some slot in contact"


@pytest.mark.parametrize("kind", ["mesh_plane", "box_mesh"])
def test_tied_depths_keep_the_lower_index_first(kind):
    """A cube flat on a plane (or on a box, its corners against the cube's
    faces): four exactly equal depths; the slots keep JAX's order."""
    Ta = _T(np.eye(3), [0.0, 0.0, 0.1 - 0.05 - 1e-3])
    Tb = _T(np.eye(3), [0.0, 0.0, 0.0])
    if kind == "box_mesh":  # the box (A) sits on the cube mesh (B)
        Ta, Tb = _T(np.eye(3), [0.0, 0.0, 0.1 + 0.06 - 1e-3]), _T(np.eye(3), [0.0, 0.0, 0.0])
    want, got = _pair(kind, "cube", Ta, Tb)
    d = np.asarray(want[2])
    assert (d[1:4] == d[0]).all() and d[0] > 0, "the case must hold a four-way tie"
    _same(got, want)


def _mesh_skeleton(verts, name):
    sk = Skeleton(name)
    sk.add_joint_and_body(FREE, parent=-1, name=name, mass=1.0, inertia=np.eye(3) * 0.002,
                          shapes=(ShapeSpec("mesh", np.zeros(1), mesh_vertices=verts),))
    return sk


def _ground():
    sk = Skeleton("ground")
    sk.add_joint_and_body(WELD, parent=-1, name="ground", mass=1.0, shapes=(
        ShapeSpec("plane", np.array([0.0, 0.0, 1.0, 0.0]), restitution=1.0),))
    return sk


def _worlds():
    """tests/test_mesh_collision.py's worlds, with a q in contact: the cube
    mesh on the ground; the cube mesh on a slab under the octahedron mesh;
    and a 12-point cloud's hull (its own slot counts) on the ground
    beside a sphere and a capsule touching it."""
    w1 = World(gravity=(0, 0, -9.81), time_step=0.001)
    w1.add_skeleton(_ground())
    w1.add_skeleton(_mesh_skeleton(_cube_verts(), "mesh"))
    q1 = np.zeros(6)
    q1[:3], q1[5] = [0.02, -0.01, 0.0], 0.098
    w2 = World(gravity=(0, 0, -9.81), time_step=0.001)
    slab = Skeleton("table")
    slab.add_joint_and_body(WELD, parent=-1, name="slab", mass=1.0, shapes=(
        ShapeSpec("box", np.array([1.0, 1.0, 0.2]), friction=1.0),))
    w2.add_skeleton(slab)
    w2.add_skeleton(_mesh_skeleton(_cube_verts(), "m1"))
    w2.add_skeleton(_mesh_skeleton(_octahedron(), "m2"))
    q2 = np.zeros(12)
    q2[:3], q2[5], q2[6:9], q2[11] = [0.0, 0.0, 0.03], 0.199, [0.02, 0.01, 0.0], 0.398
    w3 = World(gravity=(0, 0, -9.81), time_step=0.001)
    w3.add_skeleton(_ground())
    w3.add_skeleton(_mesh_skeleton(CLOUDS["cloud12"], "rock"))
    for name, shape in (("ball", ShapeSpec("sphere", np.array([0.05]))),
                        ("rod", ShapeSpec("capsule", np.array([0.03, 0.1])))):
        sk = Skeleton(name)
        sk.add_joint_and_body(FREE, parent=-1, name=name, mass=0.5, inertia=np.eye(3) * 1e-3,
                              shapes=(shape,))
        w3.add_skeleton(sk)
    q3 = np.zeros(18)
    q3[5] = 0.15
    q3[9], q3[11] = 0.2, 0.15
    q3[15], q3[17] = -0.18, 0.15
    return {"mesh_plane": (w1, q1), "mesh_box_mesh": (w2, q2), "cloud": (w3, q3)}


@pytest.mark.parametrize("name", ["mesh_plane", "mesh_box_mesh", "cloud"])
def test_slot_plans_match_jax(name):
    jw, _ = _worlds()[name]
    tw = world_from_arrays(dump_world(jw))
    jc, tc = JaxCollider(jw), Collider(tw)
    assert [(s.kind, s.body_a, s.body_b, s.n_slots) for s in tc.slots] == [
        (s.kind, s.body_a, s.body_b, s.n_slots) for s in jc.slots]
    assert tc.num_contacts == jc.num_contacts
    jb, tb = JaxBatchedCollider(jc), BatchedCollider(tc)
    for f in ("body_a", "body_b", "mu", "restitution"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))


@pytest.mark.parametrize("name", ["mesh_plane", "mesh_box_mesh", "cloud"])
def test_batched_collide_matches_jax(name):
    """B = 4 jittered copies of the world's q: every slot, slot order."""
    jw, q0 = _worlds()[name]
    tw = world_from_arrays(dump_world(jw))
    q = q0[:, None] + 0.01 * np.random.RandomState(3).randn(len(q0), 4)
    jb, tb = JaxBatchedCollider(JaxCollider(jw)), BatchedCollider(Collider(tw))
    jR, jp, *_ = ja.fk(ja.FlatWorld(jw), jnp.asarray(q))
    tR, tp, *_ = ta.fk(ta.FlatWorld(tw), t64(q))
    want, got = jb.collide(jR, jp, 4), tb.collide(tR, tp, 4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-12, rtol=0)
    assert (np.asarray(want[2]) > 0).any()


# The impulses' part in F^T's null space (rank 9 of 72 rows on the mesh
# stack): the JAX package's gathered ridged solve leaves 1.2e-7 there on
# its first step, where the port's z has none (the part along F's columns
# agrees to 4e-16).
NULL_ATOL = 1e-6


@pytest.mark.parametrize("name", ["mesh_plane", "mesh_box_mesh"])
def test_single_world_steps_match_jax(name):
    """Two warm-started steps of each engine from the world's contact q."""
    jw, q = _worlds()[name]
    tw = world_from_arrays(dump_world(jw))
    je, te = JaxEngine(jw), Engine(tw, device="cpu")
    f = jax.jit(lambda q, v, u, z: je.step(q, v, u, z_warm=z))
    rng = np.random.RandomState(4)
    v, u = 0.1 * rng.randn(len(q)), np.zeros(len(q))
    z = np.zeros(je.num_constraint_rows)
    tq, tv, tz = t64(q), t64(v), t64(z)
    for _ in range(2):
        r = f(q, v, u, z)
        s = te.step(tq, tv, t64(u), z_warm=tz)
        np.testing.assert_allclose(n(s.q), np.asarray(r.q), atol=1e-9, rtol=0)
        np.testing.assert_allclose(n(s.v), np.asarray(r.v), atol=1e-9, rtol=0)
        close_impulses(s.impulses, r.impulses, te.lcp_problem(tq, tv, t64(u)).F.numpy(),
                       null_atol=NULL_ATOL)
        assert np.abs(np.asarray(r.impulses)).max() > 0
        q, v, z = np.asarray(r.q), np.asarray(r.v), np.asarray(r.impulses)
        tq, tv, tz = s.q, s.v, s.impulses

"""nimblephysics_tpu_torch.batched.collision against the JAX package's
batched/collision.py: contact points, normals and depths of every slot
from the same seeded float64 states (B=4), to atol 1e-10. Capsule-plane
slots come from the half-cheetah; sphere-plane slots from a sphere on a
vertical slider over a tilted plane, carried across with
convert.world_from_arrays."""

import jax.numpy as jnp
import numpy as np
import pytest

from nimblephysics_tpu.batched import articulated as ja
from nimblephysics_tpu.batched.collision import BatchedCollider as JaxCollider
from nimblephysics_tpu.collision.collider import Collider as JaxPlan
from nimblephysics_tpu.dynamics import PRISMATIC, WELD, ShapeSpec, Skeleton
from nimblephysics_tpu.simulation.world import World

from nimblephysics_tpu_torch.batched import articulated as ta
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

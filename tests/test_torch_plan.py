"""The port's static plan of the half-cheetah world equals the JAX
package's: dofs, rows, contacts, the LCP row plan, limit rows, the
flattened tree and the collider's slots. Checked for the port's own
model builder and for a world carried across with
convert.world_from_arrays. The same for the 2- and 3-box stacks and the
islands scene of tests/test_islands.py (free joints, box shapes,
collision overrides), carried across with world_from_arrays."""

import numpy as np
import pytest
import torch

from nimblephysics_tpu.batched import BatchedEngine as JaxEngine
from nimblephysics_tpu.batched.articulated import FlatWorld as JaxFlat

from nimblephysics_tpu_torch.batched.articulated import FlatWorld
from nimblephysics_tpu_torch.batched.engine import BatchedEngine
from nimblephysics_tpu_torch.convert import state_to_torch, world_from_arrays
from torch_parity import box_stack_pair, dump_world, half_cheetah_pair, islands_scene

SOURCES = ["builder", "world_from_arrays"]


@pytest.fixture(scope="module")
def pair():
    jw, tw, _ = half_cheetah_pair()
    return jw, {"builder": tw, "world_from_arrays": world_from_arrays(dump_world(jw))}


@pytest.fixture(scope="module")
def engines(pair):
    jw, tws = pair
    je = JaxEngine(jw)
    return je, {k: BatchedEngine(w, device="cpu", dtype=torch.float64)
                for k, w in tws.items()}


@pytest.mark.parametrize("source", SOURCES)
def test_sizes(engines, source):
    je, tes = engines
    te = tes[source]
    assert te.world.num_dofs == je.world.num_dofs == 9
    assert te.num_rows == je.num_rows == 60
    assert te.bcollider.num_contacts == je.bcollider.num_contacts == 16
    assert len(te.assembler.limit_rows) == len(je.assembler.limit_rows) == 12
    assert te.skel_slices == je.skel_slices == [(0, 0), (0, 9)]
    assert je.islands is None and je.contact_cap is None


@pytest.mark.parametrize("source", SOURCES)
def test_lcp_meta(engines, source):
    je, tes = engines
    tm, jm = tes[source].meta, je.meta
    np.testing.assert_array_equal(tm.findex, jm.findex)
    np.testing.assert_array_equal(tm.is_friction, jm.is_friction)
    assert tm.lo_const is None and jm.lo_const is None
    assert tm.hi_const is None and jm.hi_const is None
    for f in ("iterations", "tol", "ridge", "refine_rounds",
              "seed_pgs_sweeps", "k_active", "solver"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert (tm.iterations, tm.refine_rounds, tm.seed_pgs_sweeps) == (24, 2, 0)


@pytest.mark.parametrize("source", SOURCES)
def test_limit_rows(engines, source):
    je, tes = engines
    got = [(r.dof, r.sign, r.limit) for r in tes[source].assembler.limit_rows]
    want = [(r.dof, r.sign, r.limit) for r in je.assembler.limit_rows]
    assert got == want


@pytest.mark.parametrize("source", SOURCES)
def test_flat_world(pair, source):
    jw, tws = pair
    jf, tf = JaxFlat(jw), FlatWorld(tws[source])
    assert tf.nb == jf.nb == 11
    np.testing.assert_array_equal(tf.anc, jf.anc)
    for a, b in zip(tf.G_body, jf.G_body):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-14)
    for tj, jj in zip(tf.joints, jf.joints):
        assert (tj.parent, tj.q_index, tj.num_dofs) == (
            jj.parent, jj.q_index, jj.num_dofs)
        assert tj.spec.joint_type == jj.spec.joint_type
        for f in ("R_pj", "p_pj", "R_ci", "p_ci"):
            np.testing.assert_allclose(getattr(tj, f), getattr(jj, f),
                                       rtol=1e-14, atol=1e-14)
        if jj.num_dofs:
            np.testing.assert_allclose(tj.S_const, jj.S_const, atol=1e-14)


@pytest.mark.parametrize("source", SOURCES)
def test_collider_slots(engines, source):
    je, tes = engines
    tc, jc = tes[source].bcollider, je.bcollider
    np.testing.assert_array_equal(tc.body_a, jc.body_a)
    np.testing.assert_array_equal(tc.body_b, jc.body_b)
    np.testing.assert_allclose(tc.mu, jc.mu)
    np.testing.assert_allclose(tc.restitution, jc.restitution)
    assert [s.kind for s in tc.slots] == [s.kind for s in jc.slots]
    assert {s.kind for s in tc.slots} == {"capsule_plane"}


@pytest.mark.parametrize("source", SOURCES)
def test_per_dof_coefficients(engines, source):
    je, tes = engines
    te = tes[source]
    np.testing.assert_allclose(te._c.damping[:, 0].numpy(), je.damping)
    np.testing.assert_allclose(te._c.stiffness[:, 0].numpy(), je.stiffness)
    np.testing.assert_allclose(te._c.rest_pos[:, 0].numpy(), je.rest_pos)
    np.testing.assert_allclose(te._c.force_mask[:, 0].numpy(), je.force_mask)
    np.testing.assert_array_equal(te.world.action_indices, je.world.action_indices)
    np.testing.assert_array_equal(te.world.gravity, je.world.gravity)
    assert te.world.time_step == je.world.time_step


def test_state_to_torch():
    q = np.arange(6.0).reshape(3, 2)
    tq, tv, tz = state_to_torch(q, 2 * q, device="cpu", dtype=torch.float64)
    assert tq.dtype == torch.float64 and tz is None
    np.testing.assert_array_equal(tv.numpy(), 2 * q)


BOX_WORLDS = {
    "box2": lambda: box_stack_pair(2),
    "box3": lambda: box_stack_pair(3),
    "islands": lambda: islands_scene(3),
}


@pytest.mark.parametrize("name", BOX_WORLDS)
def test_box_world_plans_match_jax(name):
    """Joints, slots, rows and LcpMeta of a world carried across."""
    from nimblephysics_tpu_torch.models import box_stack

    jw, tw, _ = BOX_WORLDS[name]()
    je, te = JaxEngine(jw), BatchedEngine(tw, device="cpu", dtype=torch.float64)
    jf, tf = je.fw, te.fw
    assert tf.nb == jf.nb and tf.nv == jf.nv
    np.testing.assert_array_equal(tf.anc, jf.anc)
    for a, b in zip(tf.G_body, jf.G_body):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-14)
    for tj, jj in zip(tf.joints, jf.joints):
        assert (tj.parent, tj.q_index, tj.num_dofs, tj.spec.joint_type) == (
            jj.parent, jj.q_index, jj.num_dofs, jj.spec.joint_type)
        for f in ("R_pj", "p_pj", "R_ci", "p_ci", "Ad_cj"):
            np.testing.assert_allclose(getattr(tj, f), getattr(jj, f), atol=1e-14)
        if jj.num_dofs:  # constant S, or S(q) for a free joint
            assert (tj.S_const is None) == (jj.S_const is None)
    tc, jc = te.bcollider, je.bcollider
    assert [(s.kind, s.body_a, s.body_b, s.n_slots) for s in tc.slots] == [
        (s.kind, s.body_a, s.body_b, s.n_slots) for s in jc.slots]
    np.testing.assert_allclose(tc.mu, jc.mu)
    np.testing.assert_allclose(tc.restitution, jc.restitution)
    assert tc.num_contacts == jc.num_contacts
    assert te.num_rows == je.num_rows and te.skel_slices == je.skel_slices
    assert te.assembler.limit_rows == [] and je.assembler.limit_rows == []
    tm, jm = te.meta, je.meta
    np.testing.assert_array_equal(tm.findex, jm.findex)
    np.testing.assert_array_equal(tm.is_friction, jm.is_friction)
    for f in ("lo_const", "hi_const", "iterations", "tol", "ridge", "refine_rounds",
              "seed_pgs_sweeps", "k_active", "solver"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert (te.islands is None) == (je.islands is None)
    assert te.contact_cap == je.contact_cap is None
    n_boxes = tf.nv // 6
    expect = {"box2": (24, 72), "box3": (48, 144), "islands": (24, 72)}[name]
    assert (tc.num_contacts, te.num_rows) == expect
    if name != "islands":
        # The port's own box_stack gives the world carried across.
        bw, q0, _ = box_stack(n_boxes)
        np.testing.assert_allclose(q0, BOX_WORLDS[name]()[2])
        assert [s.kind for s in BatchedEngine(bw, device="cpu").bcollider.slots] == [
            s.kind for s in tc.slots]

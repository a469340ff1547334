"""nimblephysics_tpu_torch's mappings (neural/mappings.py) and the mapped
snapshot against the JAX package, float64 on the CPU.

* IKMapping with spatial, linear and angular entries on the half-cheetah
  and a ball-joint chain: map_pos, map_vel and map_pos_jacobian against
  the JAX functions (each under one jax.jit of FK alone), inverse_map_pos,
  convert_joint_space_to_world_space on a trajectory, map_to_pos /
  map_to_vel at the package root.
* MappedBackpropSnapshot.backprop_mapped against the JAX one from the same
  numpy state, on the battery's ball chain, a world with no constraint
  rows (the JAX side, its step and the step's VJP, compiles in seconds
  there).
"""

import jax
import numpy as np
import pytest
import torch

import nimblephysics_tpu_torch as nt
from nimblephysics_tpu.models import half_cheetah
from nimblephysics_tpu.neural import mappings as jmap
from nimblephysics_tpu.neural.backprop_snapshot import mapped_forward_pass as jax_mapped
from nimblephysics_tpu.simulation.world import World as JaxWorld

from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.neural import mappings as tmap
from test_verify_battery import _cfg_ball_chain
from torch_parity import dump_world, ik_mapping_pair, n, t64
import worlds as W


def _chain():
    jw = JaxWorld()
    jw.add_skeleton(W.ball_chain(3))
    return jw, np.zeros(9)


def _cheetah():
    jw, q0, _ = half_cheetah()
    return jw, np.asarray(q0, np.float64)


WORLDS = {"half_cheetah": _cheetah, "ball_chain": _chain}
# Mixed entries: (kind, body).
ENTRIES = {
    "half_cheetah": [("spatial", 2), ("linear", 4), ("angular", 6), ("spatial", 0)],
    "ball_chain": [("linear", 2), ("spatial", 1), ("angular", 0)],
}


def _state(name, seed=0):
    jw, q0 = WORLDS[name]()
    rng = np.random.RandomState(seed)
    q = q0 + 0.3 * rng.randn(len(q0))
    v = rng.randn(len(q0))
    return jw, world_from_arrays(dump_world(jw)), q, v


@pytest.mark.parametrize("name", list(WORLDS))
def test_ik_mapping_matches_jax(name):
    jw, tw, q, v = _state(name)
    jm, tm = ik_mapping_pair(jw, tw, ENTRIES[name])
    assert tm.pos_dim == jm.pos_dim
    want = jax.jit(lambda q, v: (jm.map_pos(q), jm.map_vel(q, v), jm.map_pos_jacobian(q)))(
        q, v)
    got = (tm.map_pos(t64(q)), tm.map_vel(t64(q), t64(v)), tm.map_pos_jacobian(t64(q)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-12, rtol=0)
    # map_vel is J v, and the Jacobian is autograd's too.
    np.testing.assert_allclose(n(got[2]) @ v, n(got[1]), atol=1e-12)
    qt = t64(q).requires_grad_()
    rows = [torch.autograd.grad(tm.map_pos(qt)[i], qt)[0] for i in range(tm.pos_dim)]
    np.testing.assert_allclose(n(torch.stack(rows)), n(got[2]), atol=1e-12)


@pytest.mark.parametrize("name", list(WORLDS))
def test_inverse_map_pos_recovers_q(name):
    """Damped Gauss-Newton IK from a perturbed start recovers q to 1e-8 on
    a mapping that sees every dof (every body's spatial coordinates)."""
    jw, tw, q, _ = _state(name, seed=1)
    m = tmap.IKMapping(tw)
    for b in range(tw.num_bodies):
        m.add_spatial_body_node(b)
    q_init = q + 0.05 * np.random.RandomState(2).randn(len(q))
    got = m.inverse_map_pos(m.map_pos(t64(q)), t64(q_init))
    np.testing.assert_allclose(n(got), q, atol=1e-8, rtol=0)
    assert float((m.map_pos(t64(q_init)) - m.map_pos(t64(q))).abs().max()) > 1e-2


@pytest.mark.parametrize("what", ["pos", "spatial"])
def test_convert_joint_space_to_world_space_matches_jax(what):
    jw, tw, q, _ = _state("half_cheetah")
    traj = q[None] + 0.2 * np.random.RandomState(3).randn(5, len(q))
    bodies = [0, 3, 6]
    want = jax.jit(lambda x: jmap.convert_joint_space_to_world_space(
        jw, x, body_indices=bodies, what=what))(traj)
    got = tmap.convert_joint_space_to_world_space(tw, t64(traj), body_indices=bodies,
                                                  what=what)
    assert got.shape == want.shape == (5, (3 if what == "pos" else 6) * len(bodies))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-12, rtol=0)
    every = tmap.convert_joint_space_to_world_space(tw, t64(traj))
    assert every.shape == (5, 3 * tw.num_bodies)


def test_map_to_pos_and_vel_at_the_root_match_jax():
    """nt.map_to_pos / nt.map_to_vel on a state, and the gradient of a loss
    on the mapped positions through them, against the JAX functions."""
    jw, tw, q, v = _state("half_cheetah", seed=4)
    jm, tm = ik_mapping_pair(jw, tw, ENTRIES["half_cheetah"])
    state = np.concatenate([q, v])
    w = np.random.RandomState(5).randn(jm.pos_dim)

    def jax_side(s):
        pos, vel = jmap.map_to_pos(jw, jm, s), jmap.map_to_vel(jw, jm, s)
        return pos, vel, jax.grad(lambda x: jmap.map_to_pos(jw, jm, x) @ w)(s)

    want = jax.jit(jax_side)(state)
    st = t64(state).requires_grad_()
    pos, vel = nt.map_to_pos(tw, tm, st), nt.map_to_vel(tw, tm, st)
    grad = torch.autograd.grad(pos @ t64(w), st)[0]
    for a, b in zip((pos, vel, grad), want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-12, rtol=0)
    assert nt.map_to_pos is tmap.map_to_pos and nt.map_to_vel is tmap.map_to_vel


@pytest.fixture(scope="module")
def mapped_case():
    """The battery's ball chain at its state, both mappings, and the JAX
    mapped snapshot's readings under one jax.jit: the post-step mapped
    state and backprop_mapped with and without a velocity loss."""
    jw, q, v, u = _cfg_ball_chain()
    jw.set_action_space([0, 1, 2, 4])
    tw = world_from_arrays(dump_world(jw))
    jm, tm = ik_mapping_pair(jw, tw, [("spatial", 1), ("linear", 0), ("angular", 1)])
    rng = np.random.RandomState(6)
    gp, gv = rng.randn(jm.pos_dim), rng.randn(jm.pos_dim)
    state, action = np.concatenate([q, v]), u[[0, 1, 2, 4]]

    def jax_side(state, action, gp, gv):
        snap = jax_mapped(jw, state, action, {"ik": jm})
        return (snap.map_post_step("ik"), snap.backprop_mapped("ik", gp),
                snap.backprop_mapped("ik", gp, gv))

    want = jax.device_get(jax.jit(jax_side)(state, action, gp, gv))
    return tw, tm, state, action, gp, gv, want


def test_mapped_backprop_matches_jax(mapped_case):
    tw, tm, state, action, gp, gv, want = mapped_case
    assert nt.neural.get_engine(tw, device="cpu").num_constraint_rows == 0
    snap = nt.neural.mapped_forward_pass(tw, t64(state), t64(action), {"ik": tm})
    got = (snap.map_post_step("ik"), snap.backprop_mapped("ik", t64(gp)),
           snap.backprop_mapped("ik", t64(gp), t64(gv)))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-12, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        assert g.loss_wrt_mass is None and w.loss_wrt_mass is None
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-10, rtol=1e-10)


def test_identity_mapping_and_restorable_snapshot(mapped_case):
    """Through IdentityMapping, backprop_mapped is backprop itself; a
    RestorableSnapshot gives its state back."""
    tw, _, state, action, gp, _, _ = mapped_case
    nv = tw.num_dofs
    ident = tmap.IdentityMapping(tw)
    assert ident.pos_dim == nv
    assert torch.equal(ident.map_pos_jacobian(t64(state[:nv])),
                       torch.eye(nv, dtype=torch.float64))
    snap = nt.neural.mapped_forward_pass(tw, t64(state), t64(action), {"id": ident})
    g = np.random.RandomState(7).randn(2 * nv)
    got = snap.backprop_mapped("id", t64(g[:nv]), t64(g[nv:]))
    want = snap.backprop(t64(g[:nv]), t64(g[nv:]))
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    st = t64(state)
    assert tmap.RestorableSnapshot(tw, st).restore() is st

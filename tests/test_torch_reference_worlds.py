"""The reference benchmark suite's worlds and the rest of the joint types
through the port, against the JAX package, float64 on the CPU, B <= 4.

* The plans of jump_worm, catapult and inverted_double_pendulum (the
  port's own model functions and the JAX worlds carried across).
* Every joint type the batched engine takes beside revolute, prismatic,
  weld, ball and free (screw, translational, translational2d, universal,
  planar, euler and euler_free): fk, bias forces, M and the position
  update of one chain holding all of them, jax.jit once.
* Worlds with no constraint rows (inverted_double_pendulum, the euler /
  euler_free chain of tests/test_batched.py): the step, with no
  collision and no LCP, against the JAX engine's (jit; it has no LCP).
* The slice as a whole: one jump_worm step under the default
  SolverConfig against the JAX engine run op by op, once, in a module
  fixture (its jit compile takes minutes); never jitted or
  differentiated here. And train_step_batched on jump_worm and catapult.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.batched import BatchedEngine as JaxEngine
from nimblephysics_tpu.batched import articulated as ja
from nimblephysics_tpu.dynamics import Skeleton as JaxSkeleton
from nimblephysics_tpu.simulation import World as JaxWorld

from nimblephysics_tpu_torch.batched import BatchedEngine
from nimblephysics_tpu_torch.batched import articulated as ta
from nimblephysics_tpu_torch.batched import lcp_cuda
from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.models.builtin import _T
from torch_parity import F64, assert_same_plan, dump_world, n, reference_pair, t64

B = 4
# n rows and rank r of each world's LCP: 4 box-box pairs of 8 slots and 6
# limit rows; 7 pairs (the target does not collide) and 6; none.
SIZES = {"jump_worm": (102, 5), "catapult": (174, 5), "inverted_double_pendulum": (0, 3)}


@pytest.mark.parametrize("name", SIZES)
def test_reference_world_plans_match_jax(name):
    """Joints, slots, rows, LcpMeta, islands of the port's own model and
    of the JAX world carried across, against the JAX engine's."""
    jw, tw, tw2, _ = reference_pair(name)
    je = JaxEngine(jw)
    for w in (tw, tw2):
        te = BatchedEngine(w, **F64)
        assert_same_plan(te, je)
        assert (te.num_rows, w.num_dofs) == SIZES[name]
        np.testing.assert_array_equal(w.action_indices, jw.action_indices)
        np.testing.assert_array_equal(w.gravity, jw.gravity)
        assert w.time_step == jw.time_step


# -- the joint types ------------------------------------------------------------

_TYPES = [
    ("screw", dict(axis=[0.0, 0.0, 1.0], screw_pitch=0.3)),
    ("translational", {}),
    ("translational2d", dict(axes=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])),
    ("universal", dict(axes=[[1.0, 0.0, 0.0], [0.0, 0.6, 0.8]])),
    ("planar", dict(axes=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])),
    ("euler", dict(euler_order="zyx")),
    ("eulerfree", dict(euler_order="xzy")),
]


def _chain_world():
    """One skeleton chaining a joint of each type above, with seeded
    offsets T_pj, T_cj, COMs and inertias (JAX package world)."""
    rng = np.random.RandomState(0)
    w = JaxWorld(gravity=(0.1, -9.81, 0.3))
    sk = JaxSkeleton("chain")
    body = -1
    for i, (kind, kw) in enumerate(_TYPES):
        body = sk.add_joint_and_body(
            kind, parent=body, T_pj=_T(0.2 * rng.randn(3), (0.3, -0.2, 0.5)),
            T_cj=_T(0.2 * rng.randn(3), (0.1, 0.2, -0.3)), mass=1.0 + 0.1 * i,
            com=0.05 * rng.randn(3), inertia=np.diag([0.11, 0.21, 0.16]), **kw)
    w.add_skeleton(sk)
    return w


QUANTITIES = ["fk", "bias", "mass", "integrate"]


@pytest.fixture(scope="module")
def joint_types():
    jw = _chain_world()
    tw = world_from_arrays(dump_world(jw))
    jf, tf = ja.FlatWorld(jw), ta.FlatWorld(tw)
    rng = np.random.RandomState(1)
    q, v = 0.5 * rng.randn(jw.num_dofs, B), rng.randn(jw.num_dofs, B)

    def both(m, fw, q, v, *grav):
        R, p, W, S, rels = m.fk(fw, q)
        stack = jnp.stack if m is ja else torch.stack
        return dict(fk=(stack(R), stack(p), W),
                    bias=(m.bias_forces(fw, q, v, rels, S, *grav),),
                    mass=tuple(m.mass_matrix_blocks(fw, R, p, W)),
                    integrate=(m.integrate_positions(fw, q, v, 0.01),))

    want = jax.jit(lambda q, v: both(ja, jf, q, v, jw.gravity))(jnp.asarray(q), jnp.asarray(v))
    return both(ta, tf, t64(q), t64(v)), want, tf


@pytest.mark.parametrize("what", QUANTITIES)
def test_joint_types_match_jax(joint_types, what):
    """World rotations, positions and W; C(q, v) with the chain joints'
    closed-form S-dot; the mass matrix; the position update: to 1e-12
    (values up to ~30 in the bias forces)."""
    got, want, tf = joint_types
    assert [jp.spec.joint_type for jp in tf.joints] == [k for k, _ in _TYPES]
    assert len(tf.chain_joints) == 4
    for a, b in zip(got[what], want[what]):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-12, atol=1e-12)


# -- worlds with no constraint rows -----------------------------------------------


def _euler_chain():
    """tests/test_batched.py::test_batched_euler_joints_match's world."""
    sk = JaxSkeleton("euler_chain")
    a = sk.add_joint_and_body("eulerfree", parent=-1, name="base", euler_order="zyx",
                              mass=1.2, inertia=np.eye(3) * 0.02)
    sk.add_joint_and_body("euler", parent=a, name="tip", euler_order="xyz",
                          T_pj=_T((0.1, 0.0, -0.2)), mass=0.7, inertia=np.eye(3) * 0.01)
    w = JaxWorld(gravity=(0.0, 0.0, -9.81), time_step=0.001)
    w.add_skeleton(sk)
    return w


@pytest.mark.parametrize("name", ["inverted_double_pendulum", "euler_chain"])
def test_no_row_steps_match_jax(name, monkeypatch):
    """A world with no rows steps with no collision and no LCP (no seed,
    no kernel, no boxed_lcp_b call): q, v and v_pre against the JAX
    engine's step at 1e-9 (tests/test_batched.py's limit), impulses (0, B)."""
    from nimblephysics_tpu_torch.batched import engine as tengine

    if name == "euler_chain":
        jw = _euler_chain()
        tw = world_from_arrays(dump_world(jw))
    else:
        jw, tw, _, _ = reference_pair(name)
    je, te = JaxEngine(jw), BatchedEngine(tw, **F64)
    assert te.num_rows == 0 and te.islands is None
    rng = np.random.RandomState(5)
    q, v, u = (s * rng.randn(tw.num_dofs, 3) for s in (0.4, 0.4, 0.2))

    def refuse(*_, **__):
        raise AssertionError("a world with no rows reached the LCP")

    monkeypatch.setattr(tengine, "boxed_lcp_b", refuse)
    monkeypatch.setattr(te.bcollider, "collide", refuse)
    before = lcp_cuda.apgd_seed.launches
    got = te.step(t64(q), t64(v), t64(u))
    want = jax.jit(lambda q, v, u: je.step(q, v, u))(*map(jnp.asarray, (q, v, u)))
    for f in ("q", "v", "v_pre"):
        np.testing.assert_allclose(n(getattr(got, f)), n(getattr(want, f)), rtol=0, atol=1e-9)
    assert got.impulses.shape == (0, 3) and got.contact_depths.shape == (0, 3)
    assert lcp_cuda.apgd_seed.launches == before
    r = te.remat_step(*(t64(x).requires_grad_() for x in (q, v, u)))
    assert torch.equal(r.v.detach(), got.v)


# -- the slice as a whole: jump_worm under the default SolverConfig -----------------

Q_TOL, V_TOL, Z_TOL = 1e-10, 1e-7, 1e-7  # as tests/test_torch_boxstack.py


@pytest.fixture(scope="module")
def worm_step():
    """One default-config step of 4 jump worms from the reference suite's
    start (q0 + 0.003 N(0, 1)) with seeded tail torques, the JAX engine op
    by op (never compiled)."""
    jw, tw, _, q0 = reference_pair("jump_worm")
    je, te = JaxEngine(jw), BatchedEngine(tw, **F64)
    rng = np.random.RandomState(11)
    q = q0[:, None] + 0.003 * rng.randn(5, B)
    v = 0.05 * rng.randn(5, B)
    u = np.zeros((5, B))
    u[2:] = 5.0 * rng.randn(3, B)
    jr = je.step(*map(jnp.asarray, (q, v, u)))
    tr = te.step(t64(q), t64(v), t64(u))
    return jr, tr


def test_jump_worm_step_matches_jax(worm_step):
    jr, tr = worm_step
    np.testing.assert_allclose(n(tr.q), n(jr.q), atol=Q_TOL, rtol=Q_TOL)
    np.testing.assert_allclose(n(tr.v), n(jr.v), atol=V_TOL, rtol=V_TOL)
    np.testing.assert_allclose(n(tr.impulses), n(jr.impulses), atol=Z_TOL, rtol=Z_TOL)
    np.testing.assert_allclose(n(tr.contact_depths), n(jr.contact_depths), atol=1e-12)
    np.testing.assert_allclose(n(tr.contact_points), n(jr.contact_points), atol=1e-12)
    assert np.abs(n(tr.impulses)).max() > 1e-3, "the worm must touch the floor"


@pytest.mark.parametrize("name", ["jump_worm", "catapult"])
def test_train_step_runs_on_reference_worlds(name):
    """train_step_batched (remat_step under the default config) on the
    reference suite's worlds, 2 worlds x horizon 2: a finite, nonzero
    policy gradient and finite states."""
    from nimblephysics_tpu_torch.parallel import MlpPolicy, train_step_batched

    _, tw, _, q0 = reference_pair(name)
    eng = BatchedEngine(tw, **F64)
    policy = MlpPolicy(2 * tw.num_dofs, tw.action_size, 8, **F64)
    rng = np.random.RandomState(12)
    states = t64(np.concatenate([q0[:, None] + 0.003 * rng.randn(5, 2), np.zeros((5, 2))]))
    res = train_step_batched(eng, policy, horizon=2)(states)
    g = torch.cat([p.grad.reshape(-1) for p in policy.parameters()])
    assert bool(torch.isfinite(res.states).all()) and bool(torch.isfinite(g).all())
    assert float(g.norm()) > 0

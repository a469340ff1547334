"""Per-world body parameters (masses, COMs, inertias, scales) in the port,
against the JAX package, float64 on the CPU.

* `_prepare_body_params` against the JAX engine's, every key, shared
  ((NB,), (NB, 3), ...) and per world ((NB, B), (NB, 3, B), ...);
* fk with scales, bias_forces with G_list and scales, mass_matrix_blocks
  with G_list, against the JAX functions under one jax.jit, on the
  half-cheetah and on a chain of every closed-form joint type;
* inverted_double_pendulum (no rows) stepped with jittered masses, COMs
  and scales against the JAX BatchedEngine run op by op, and the gradients
  of sum(v^2) in masses and scales against jax.grad op by op
  (tests/test_batched.py's limits: 1e-9; 1e-7 abs and 1e-6 rel);
* a contact step's gradient in masses against central differences at a
  fixed active set (step 1e-4, tests/test_torch_grad.py's limit 1e-4);
* remat_step's gradients in masses and scales equal to step's;
* state_step with masses against the JAX state_step.

No JAX engine is jitted: its half-cheetah step compiles for minutes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.batched import BatchedEngine as JaxEngine
from nimblephysics_tpu.batched import articulated as ja

from nimblephysics_tpu_torch.batched import BatchedEngine
from nimblephysics_tpu_torch.batched import articulated as ta
from nimblephysics_tpu_torch.batched import lcp as tlcp
from nimblephysics_tpu_torch.convert import world_from_arrays
from test_torch_reference_worlds import _chain_world
from torch_parity import F64, batch_states, dump_world, half_cheetah_pair, n, reference_pair, t64

B = 3
FD_H = 1e-4
FD_TOL = 1e-4


def _jitter(world, rng, B):
    """tests/test_batched.py's per-world jitter: masses x (1 + 0.1 U),
    COMs + 0.01 N(0, 1), scales 1 + 0.05 U, as numpy (NB, ..., B)."""
    bodies = [b for s in world.skeletons for b in s.bodies]
    NB = len(bodies)
    masses = np.array([b.mass for b in bodies])[:, None] * (1.0 + 0.1 * rng.rand(NB, B))
    coms = np.stack([b.com for b in bodies])[:, :, None] + 0.01 * rng.randn(NB, 3, B)
    scales = 1.0 + 0.05 * rng.rand(NB, 3, B)
    return dict(masses=masses, coms=coms, scales=scales)


def _params(world, keys, shape, rng):
    """One body_params dict of `keys` ("+"-joined), shared across worlds
    or per world."""
    bp = _jitter(world, rng, B)
    NB = bp["masses"].shape[0]
    inertia = np.stack([np.diag(1.0 + rng.rand(3)) * 0.05 for _ in range(NB)])
    bp["inertias"] = inertia[..., None] * (1.0 + 0.1 * rng.rand(NB, 1, 1, B))
    return {k: bp[k][..., 0] if shape == "shared" else bp[k] for k in keys.split("+")}


@pytest.fixture(scope="module")
def cheetah():
    jw, tw, q0 = half_cheetah_pair()
    return jw, tw, q0, JaxEngine(jw), BatchedEngine(tw, **F64)


@pytest.mark.parametrize("shape", ["shared", "per_world"])
@pytest.mark.parametrize("keys", ["masses", "masses+coms", "masses+inertias",
                                  "masses+scales", "masses+coms+inertias+scales",
                                  "coms+scales"])
def test_prepare_body_params_matches_jax(cheetah, keys, shape):
    """The JAX package's _prepare_body_params reads masses in every case
    (without them it broadcasts a (1, 1) mass to (B,) and raises), so the
    case without masses is held against it with the nominal masses passed
    explicitly: m / m0 = 1 leaves the inertias as they are."""
    jw, _, _, je, te = cheetah
    bp = _params(jw, keys, shape, np.random.RandomState(3))
    jbp = {k: jnp.asarray(x) for k, x in bp.items()}
    if "masses" not in jbp:
        jbp["masses"] = jnp.asarray([b.mass for s in jw.skeletons for b in s.bodies])
    js, jG = je._prepare_body_params(jbp, jnp.float64, B)
    ts, tG = te._prepare_body_params({k: t64(x) for k, x in bp.items()}, torch.float64, B)
    assert len(tG) == len(jG) == jw.num_bodies
    for a, b in zip(tG, jG):
        assert tuple(a.shape) == (6, 6, B)
        np.testing.assert_allclose(n(a), np.broadcast_to(n(b), (6, 6, B)), rtol=1e-12, atol=1e-12)
    assert (ts is None) == (js is None)
    if ts is not None:
        np.testing.assert_allclose(n(ts), n(js), rtol=0, atol=0)
    assert te._prepare_body_params(None, torch.float64, B) == (None, None)


WORLDS = ["half_cheetah", "chain"]
QUANTITIES = ["fk", "bias", "mass"]


@pytest.fixture(scope="module")
def scaled_dynamics(cheetah):
    """fk(scales), bias_forces(G_list, scales) and mass_matrix_blocks(G_list)
    of both packages: name -> (port, JAX), each world's JAX side compiled
    at its first test (a test worker runs only the worlds it meets)."""
    out = {}

    def get(name):
        if name not in out:
            out[name] = _scaled_dynamics(cheetah, name)
        return out[name]

    return get


def _scaled_dynamics(cheetah, name):
    if name == "half_cheetah":
        jw, tw, q0, je, te = cheetah
    else:
        jw = _chain_world()
        tw = world_from_arrays(dump_world(jw))
        je, te = JaxEngine(jw), BatchedEngine(tw, **F64)
        q0 = np.zeros(jw.num_dofs)
    rng = np.random.RandomState(7)
    q = q0[:, None] + 0.3 * rng.randn(jw.num_dofs, B)
    v = rng.randn(jw.num_dofs, B)
    bp = _jitter(jw, rng, B)

    def both(m, fw, q, v, scales, G_list, *grav):
        R, p, W, S, rels = m.fk(fw, q, scales=scales)
        stack = jnp.stack if m is ja else torch.stack
        return dict(fk=(stack(R), stack(p), W),
                    bias=(m.bias_forces(fw, q, v, rels, S, *grav, G_list=G_list,
                                        scales=scales),),
                    mass=tuple(m.mass_matrix_blocks(fw, R, p, W, G_list=G_list)))

    def jax_side(q, v, bp):
        scales, G_list = je._prepare_body_params(bp, jnp.float64, B)
        return both(ja, je.fw, q, v, scales, G_list, jw.gravity)

    want = jax.jit(jax_side)(jnp.asarray(q), jnp.asarray(v),
                             {k: jnp.asarray(x) for k, x in bp.items()})
    scales, G_list = te._prepare_body_params({k: t64(x) for k, x in bp.items()},
                                             torch.float64, B)
    return both(ta, te.fw, t64(q), t64(v), scales, G_list), want


@pytest.mark.parametrize("what", QUANTITIES)
@pytest.mark.parametrize("name", WORLDS)
def test_scaled_dynamics_match_jax(scaled_dynamics, name, what):
    """World rotations, positions and W with scaled anchors; C(q, v) with
    the per-world inertias and the scaled S and S-dot; the mass matrix with
    the per-world inertias: to 1e-12."""
    got, want = scaled_dynamics(name)
    for a, b in zip(got[what], want[what]):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def pendulum():
    jw, tw, _, q0 = reference_pair("inverted_double_pendulum")
    je, te = JaxEngine(jw), BatchedEngine(tw, **F64)
    rng = np.random.RandomState(5)
    q, v, u = (s * rng.randn(tw.num_dofs, B) for s in (0.4, 0.4, 0.2))
    return jw, je, te, (q, v, u), _jitter(jw, rng, B)


def test_no_row_step_with_body_params_matches_jax(pendulum):
    jw, je, te, (q, v, u), bp = pendulum
    assert te.num_rows == 0
    want = je.step(*map(jnp.asarray, (q, v, u)),
                   body_params={k: jnp.asarray(x) for k, x in bp.items()})
    got = te.step(t64(q), t64(v), t64(u), body_params={k: t64(x) for k, x in bp.items()})
    for f in ("q", "v", "v_pre"):
        np.testing.assert_allclose(n(getattr(got, f)), n(getattr(want, f)), rtol=0, atol=1e-9)
    plain = te.step(t64(q), t64(v), t64(u))
    assert float((plain.v - got.v).abs().max()) > 1e-6, "the body parameters changed nothing"


def test_no_row_step_gradients_match_jax(pendulum):
    """d sum(v^2) / d masses and / d scales (COMs held), port autograd
    against jax.grad of the JAX engine's step, op by op."""
    jw, je, te, (q, v, u), bp = pendulum
    jq, jv, ju = map(jnp.asarray, (q, v, u))

    def loss_j(m, s):
        r = je.step(jq, jv, ju, body_params={"masses": m, "coms": jnp.asarray(bp["coms"]),
                                             "scales": s})
        return jnp.sum(r.v ** 2)

    gm, gs = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(bp["masses"]), jnp.asarray(bp["scales"]))
    m, s = t64(bp["masses"]).requires_grad_(), t64(bp["scales"]).requires_grad_()
    r = te.step(t64(q), t64(v), t64(u), body_params={"masses": m, "coms": t64(bp["coms"]),
                                                     "scales": s})
    tm, ts = torch.autograd.grad((r.v ** 2).sum(), (m, s))
    np.testing.assert_allclose(n(tm), n(gm), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(n(ts), n(gs), atol=1e-7, rtol=1e-6)
    assert float(tm.abs().max()) > 1e-6 and float(ts.abs().max()) > 1e-6


def test_state_step_with_masses_matches_jax(pendulum):
    jw, je, te, (q, v, u), bp = pendulum
    state = np.concatenate([q, v])
    action = u[: jw.action_size]
    want = je.state_step(jnp.asarray(state), jnp.asarray(action), masses=jnp.asarray(bp["masses"]))
    got = te.state_step(t64(state), t64(action), masses=t64(bp["masses"]))
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-9)
    shared = te.state_step(t64(state), t64(action), masses=t64(bp["masses"][:, 0]))
    want_shared = je.state_step(jnp.asarray(state), jnp.asarray(action),
                                masses=jnp.asarray(bp["masses"][:, 0]))
    np.testing.assert_allclose(n(shared), n(want_shared), rtol=0, atol=1e-9)


def _ball_on_ground():
    """A free sphere (radius 0.1, 1.3 kg) on the z = 0 plane, the default
    SolverConfig: one contact, three rows, a full-rank active set."""
    from nimblephysics_tpu_torch.dynamics import FREE, WELD, ShapeSpec, Skeleton
    from nimblephysics_tpu_torch.simulation import World

    world = World()
    ball = Skeleton("ball")
    ball.add_joint_and_body(FREE, name="ball", mass=1.3, inertia=np.eye(3) * 0.006,
                            shapes=(ShapeSpec("sphere", np.array([0.1])),))
    ground = Skeleton("ground")
    ground.add_joint_and_body(WELD, name="ground", shapes=(
        ShapeSpec("plane", np.array([0.0, 0.0, 1.0, 0.0])),))
    world.add_skeleton(ball)
    world.add_skeleton(ground)
    return world


def test_contact_step_mass_gradient_matches_finite_differences():
    """A sphere 1 mm into the ground, at rest up to 0.02 N(0, 1) velocities
    (static friction: every row clamps): the VJP of one step in per-world
    masses (inertias held, so that m changes the mass-to-inertia ratio;
    with inertias scaled by m / m0 the impulse step does not depend on m)
    against central differences along random directions, the active set
    fixed within the difference. The rows are full rank, so the pinned
    solve carries no ridge and the differences agree to ~1e-8."""
    eng = BatchedEngine(_ball_on_ground(), **F64)
    assert eng.num_rows == 3
    rng = np.random.RandomState(3)
    q = np.zeros((6, 2))
    q[:3] = 0.1 * rng.randn(3, 2)
    q[5] = 0.1 - 1e-3
    q, v = t64(q), t64(0.02 * rng.randn(6, 2))
    u = torch.zeros_like(q)
    m0 = 1.3 * (1.0 + 0.1 * rng.rand(2, 2))
    inertias = t64(np.tile(np.eye(3) * 0.006, (2, 1, 1)))
    wv = t64(rng.randn(6, 2))
    m = t64(m0).requires_grad_()
    r = eng.step(q, v, u, body_params={"masses": m, "inertias": inertias})
    (g,) = torch.autograd.grad((wv * r.v).sum(), m)

    def loss_and_masks(masses):
        body = eng._prepare_body_params({"masses": t64(masses), "inertias": inertias},
                                        torch.float64, 2)
        p = eng.lcp_problem(q, v, u, body)
        z, saved = tlcp.boxed_lcp_b(eng.meta, p.F, p.b, p.mu, torch.zeros_like(p.b),
                                    return_saved=True)
        return float((wv * eng._finish(q, v, p, z).v).sum()), saved, z

    _, s0, z0 = loss_and_masks(m0)
    assert float(z0[0].min()) > 0 and bool(s0.valid.all())
    for _ in range(3):
        d = rng.randn(*m0.shape)
        side = []
        for sgn in (1.0, -1.0):
            L, s, _ = loss_and_masks(m0 + sgn * FD_H * d)
            for a, c in zip(s[2:7], s0[2:7]):
                assert torch.equal(a, c), "the active set moved within the difference"
            side.append(L)
        fd = (side[0] - side[1]) / (2 * FD_H)
        ad = float((g * t64(d)).sum())
        assert abs(ad) > 1e-3
        assert abs(fd - ad) <= FD_TOL * abs(ad), (fd, ad)


def test_remat_step_body_param_gradients_equal_step(cheetah):
    """remat_step takes the body tensors as inputs of its checkpoint: the
    same values, and the same gradients in masses, scales and q as step."""
    _, tw, q0, _, te = cheetah
    q, v, u = (t64(x) for x in batch_states(q0, B, seed=24, drop=-0.26))
    bp = _jitter(tw, np.random.RandomState(8), B)
    rng = np.random.RandomState(9)
    wq, wv = t64(rng.randn(*q.shape)), t64(rng.randn(*v.shape))
    grads = []
    for fn in (te.step, te.remat_step):
        m, s = t64(bp["masses"]).requires_grad_(), t64(bp["scales"]).requires_grad_()
        qq = q.clone().requires_grad_()
        r = fn(qq, v, u, body_params={"masses": m, "scales": s, "coms": t64(bp["coms"])})
        grads.append((r.v.detach(), *torch.autograd.grad(
            (wq * r.q).sum() + (wv * r.v).sum(), (m, s, qq))))
    assert float(grads[0][0].abs().max()) > 0
    for a, b in zip(*grads):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-10, atol=1e-12)
    assert float(grads[0][1].abs().max()) > 0 and float(grads[0][2].abs().max()) > 0

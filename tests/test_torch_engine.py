"""The port's BatchedEngine against the JAX package's, float64 on the CPU:
four warm-started half-cheetah steps (B=4, SolverConfig.throughput())
from the same seeded states, q, v and impulses compared after every
step.

"air_-0.55" is tests/test_batched.py's ground case (root height -0.55:
contact slots penetrate, but deeper than the clipping depth, so the LCP
rows stay inactive) and keeps that test's tolerances. "ground_-0.25"
puts feet within the clipping depth, so the LCP is active and the
impulses are non-zero. Its pinned solves are ridged normal equations
(relative ridge 1e-10), which amplify roundoff differences between the
two implementations by up to ~1e10 * eps; the tolerances on v and z are
set from that, 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.batched import BatchedEngine as JaxEngine

from nimblephysics_tpu_torch.batched.engine import BatchedEngine
from torch_parity import F64, batch_states, half_cheetah_pair, n, t64

B = 4
CASES = {
    # name: (root drop, q tol, v tol, z tol)
    "air_-0.55": (-0.55, 1e-10, 1e-9, 1e-9),
    "ground_-0.27": (-0.27, 1e-10, 1e-7, 1e-7),
}


@pytest.fixture(scope="module")
def engines():
    jw, tw, q0 = half_cheetah_pair()
    je = JaxEngine(jw)
    step = jax.jit(lambda q, v, u, z: je.step(q, v, u, z_warm=z))
    return je, step, BatchedEngine(tw, **F64), q0


@pytest.mark.parametrize("case", CASES)
def test_four_warm_started_steps_match_jax(engines, case):
    je, jstep, te, q0 = engines
    drop, qtol, vtol, ztol = CASES[case]
    q, v, u = batch_states(q0, B, seed=7, drop=drop)
    z = np.zeros((te.num_rows, B))
    saw_contact, max_impulse = False, 0.0
    jq, jv, jz = jnp.asarray(q), jnp.asarray(v), jnp.asarray(z)
    tq, tv, tz, tu = t64(q), t64(v), t64(z), t64(u)
    for _ in range(4):
        jr = jstep(jq, jv, jnp.asarray(u), jz)
        tr = te.step(tq, tv, tu, z_warm=tz)
        np.testing.assert_allclose(n(tr.q), n(jr.q), atol=qtol, rtol=qtol)
        np.testing.assert_allclose(n(tr.v), n(jr.v), atol=vtol, rtol=vtol)
        np.testing.assert_allclose(n(tr.impulses), n(jr.impulses),
                                   atol=ztol, rtol=ztol)
        np.testing.assert_allclose(n(tr.contact_depths), n(jr.contact_depths),
                                   atol=1e-12)
        saw_contact |= bool((n(tr.contact_depths) > 0).any())
        max_impulse = max(max_impulse, float(np.abs(n(tr.impulses)).max()))
        # Each side carries its own state forward.
        jq, jv, jz = jr.q, jr.v, jr.impulses
        tq, tv, tz = tr.q, tr.v, tr.impulses
    assert saw_contact, "the ground cases must see contact"
    if case.startswith("ground"):
        assert max_impulse > 0, "the LCP must carry impulses"


def test_action_to_forces_and_state_step_match_jax(engines):
    je, jstep, te, q0 = engines
    q, v, _ = batch_states(q0, B, seed=3, drop=-0.25)
    a = np.random.RandomState(4).randn(te.world.action_size, B)
    np.testing.assert_array_equal(
        n(te.action_to_forces(t64(a))), n(je.action_to_forces(jnp.asarray(a))))
    # JAX state_step is step(q, v, action_to_forces(a)) with a cold LCP
    # start; the jitted step of the fixture computes it without a retrace.
    jr = jstep(jnp.asarray(q), jnp.asarray(v),
               je.action_to_forces(jnp.asarray(a)), jnp.zeros((te.num_rows, B)))
    got = te.state_step(t64(np.concatenate([q, v])), t64(a))
    np.testing.assert_allclose(n(got), np.concatenate([n(jr.q), n(jr.v)]),
                               atol=1e-7, rtol=1e-7)


def test_engine_rejects_wrong_device_or_dtype(engines):
    _, _, te, q0 = engines
    q = torch.zeros(9, 2, dtype=torch.float32)
    with pytest.raises(ValueError, match="float64"):
        te.step(q, q, q)

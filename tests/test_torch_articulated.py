"""nimblephysics_tpu_torch.batched.articulated against the JAX package's
batched/articulated.py on the half-cheetah: fk, bias_forces,
mass_matrix_blocks and integrate_positions from the same seeded float64
states (B=4), agreement to atol 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest

from nimblephysics_tpu.batched import articulated as ja

from nimblephysics_tpu_torch.batched import articulated as ta
from torch_parity import batch_states, half_cheetah_pair, n, t64

B = 4
STATES = {"air": 0.0, "ground": -0.25}


@pytest.fixture(scope="module")
def flats():
    jw, tw, q0 = half_cheetah_pair()
    return ja.FlatWorld(jw), ta.FlatWorld(tw), q0, jw.gravity


def _run(flats, drop):
    jf, tf, q0, g = flats
    q, v, _ = batch_states(q0, B, seed=5, drop=drop)
    jout = ja.fk(jf, jnp.asarray(q))
    tout = ta.fk(tf, t64(q))
    return jf, tf, q, v, g, jout, tout


@pytest.mark.parametrize("state", STATES)
def test_fk(flats, state):
    *_, jout, tout = _run(flats, STATES[state])
    for a, b in zip(tout[0], jout[0]):
        np.testing.assert_allclose(n(a), n(jnp.broadcast_to(b, a.shape)), atol=1e-10)
    for a, b in zip(tout[1], jout[1]):
        np.testing.assert_allclose(n(a), n(jnp.broadcast_to(b, a.shape)), atol=1e-10)
    np.testing.assert_allclose(n(tout[2]), n(jout[2]), atol=1e-10)


@pytest.mark.parametrize("state", STATES)
def test_bias_forces(flats, state):
    jf, tf, q, v, g, jout, tout = _run(flats, STATES[state])
    want = ja.bias_forces(jf, jnp.asarray(q), jnp.asarray(v), jout[4], jout[3], g)
    got = ta.bias_forces(tf, t64(q), t64(v), tout[4], tout[3])
    np.testing.assert_allclose(n(got), n(want), atol=1e-10)


@pytest.mark.parametrize("state", STATES)
def test_mass_matrix_blocks(flats, state):
    jf, tf, q, v, g, jout, tout = _run(flats, STATES[state])
    want = ja.mass_matrix_blocks(jf, jout[0], jout[1], jout[2])
    got = ta.mass_matrix_blocks(tf, tout[0], tout[1], tout[2])
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), atol=1e-10)


@pytest.mark.parametrize("state", STATES)
def test_integrate_positions(flats, state):
    jf, tf, q, v, *_ = _run(flats, STATES[state])
    want = ja.integrate_positions(jf, jnp.asarray(q), jnp.asarray(v), 0.002)
    got = ta.integrate_positions(tf, t64(q), t64(v), 0.002)
    np.testing.assert_allclose(n(got), n(want), atol=1e-12)

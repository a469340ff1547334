"""nimblephysics_tpu_torch.batched.linalg against the JAX package's
batched/linalg.py: the same seeded float64 inputs (trailing batch B=4)
through both, agreement to atol 1e-10 (roundoff of a few small sums)."""

import jax.numpy as jnp
import numpy as np
import pytest

from nimblephysics_tpu.batched import linalg as jl

from nimblephysics_tpu_torch.batched import linalg as tl
from torch_parity import n, t64

B = 4


def _spd(rng, k):
    A = rng.randn(k, k, B)
    return np.einsum("ikb,jkb->ijb", A, A) + k * np.eye(k)[..., None]


def _lower(rng, k):
    return np.tril(np.ones((k, k)))[..., None] * rng.randn(k, k, B) + (
        3.0 * np.eye(k)[..., None]
    )


def _inputs(name, rng):
    r = rng.randn
    return {
        "mv": (r(4, 3, B), r(3, B)),
        "mtv": (r(3, 4, B), r(3, B)),
        "mm": (r(3, 5, B), r(5, 2, B)),
        "cross": (r(3, B), r(3, B)),
        "gram": (r(7, 3, B), r(7, 2, B)),
        "skew": (r(3, B),),
        "ad_apply": (r(6, B), r(6, B)),
        "dad_apply": (r(6, B), r(6, B)),
        "cholesky": (_spd(rng, 9),),
        "solve_tri_lower": (_lower(rng, 9), r(9, 5, B)),
        "solve_tri_upper_t": (_lower(rng, 9), r(9, 5, B)),
        "solve_tri_lower_vec": (_lower(rng, 9), r(9, B)),
        "solve_tri_upper_t_vec": (_lower(rng, 9), r(9, B)),
    }[name]


NAMES = ["mv", "mtv", "mm", "cross", "gram",
         "skew", "ad_apply", "dad_apply", "cholesky", "solve_tri_lower",
         "solve_tri_upper_t", "solve_tri_lower_vec", "solve_tri_upper_t_vec"]


@pytest.mark.parametrize("name", NAMES)
def test_helper_matches_jax(name):
    args = _inputs(name, np.random.RandomState(NAMES.index(name)))
    want = getattr(jl, name)(*[jnp.asarray(a) for a in args])
    got = getattr(tl, name)(*[t64(a) for a in args])
    np.testing.assert_allclose(n(got), n(want), atol=1e-10, rtol=1e-10)


def test_block_factor_and_solves_match_jax():
    rng = np.random.RandomState(11)
    slices = [(0, 0), (0, 4), (4, 9)]
    Ms = [np.zeros((0, 0, B)), _spd(rng, 4), _spd(rng, 5)]
    rhs = rng.randn(9, 3, B)
    jLs = jl.block_cholesky([jnp.asarray(M) for M in Ms])
    tLs = tl.block_cholesky([t64(M) for M in Ms])
    for a, b in zip(tLs, jLs):
        np.testing.assert_allclose(n(a), n(b), atol=1e-10)
    for name in ("block_solve_tri_lower", "block_solve_tri_upper_t"):
        want = getattr(jl, name)(jLs, slices, jnp.asarray(rhs))
        got = getattr(tl, name)(tLs, slices, t64(rhs))
        np.testing.assert_allclose(n(got), n(want), atol=1e-10)
    want = jl.block_solve_tri_upper_t_vec(jLs, slices, jnp.asarray(rhs[:, 0]))
    got = tl.block_solve_tri_upper_t_vec(tLs, slices, t64(rhs[:, 0]))
    np.testing.assert_allclose(n(got), n(want), atol=1e-10)


def test_cholesky_pivot_guard_stays_finite():
    """A singular PSD matrix: the guarded pivot keeps the factor finite
    where an unguarded sqrt of a negative roundoff gives NaN."""
    v = np.random.RandomState(3).randn(4, 1, B)
    A = np.einsum("ikb,jkb->ijb", v, v)  # rank 1
    got = n(tl.cholesky(t64(A)))
    want = n(jl.cholesky(jnp.asarray(A)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)

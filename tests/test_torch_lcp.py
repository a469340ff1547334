"""The port's batched LCP against the JAX package's, float64 on the CPU.

* apgd_plain against batched/lcp._apgd, and against the TPU kernel body
  lcp_pallas._apgd_kernel itself run by Pallas in interpret mode;
* the classification, refinement, pinned solves (cfm = 0 and the
  Woodbury cfm > 0 rung) and validity check;
* the forward boxed_lcp_b under the throughput meta (ladder always on).

Inputs (n=60, r=9, B=8, the half-cheetah row plan) are made with numpy
from a seed: "contact" is the LCP the port's engine assembles for
half-cheetahs on the ground, "random" a seeded random F, b, mu, z0.

The iterative seed and the masks agree to roundoff (1e-10). The pinned
solves are ridged normal equations (relative ridge 1e-10 in float64)
whose conditioning amplifies the two implementations' different
summation orders by up to ~1e10 * eps, so impulses from them are held to
1e-7.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.batched import lcp as jlcp
from nimblephysics_tpu.batched import lcp_pallas
from nimblephysics_tpu.batched import BatchedEngine as JaxEngine

from nimblephysics_tpu_torch.batched import lcp as tlcp
from nimblephysics_tpu_torch.batched import lcp_cuda
from nimblephysics_tpu_torch.batched.engine import BatchedEngine
from torch_parity import F64, batch_states, half_cheetah_pair, n, t64

B = 8
CASES = ["contact", "random"]


@pytest.fixture(scope="module")
def problems():
    jw, tw, q0 = half_cheetah_pair()
    je = JaxEngine(jw)
    te = BatchedEngine(tw, **F64)
    q, v, u = batch_states(q0, B, seed=1, drop=-0.25, spread=0.02)
    p = te.lcp_problem(t64(q), t64(v), t64(u))
    rng = np.random.RandomState(2)
    nrow = te.num_rows
    mu_r = np.where(te.meta.is_friction[:, None], 0.9, 0.0) * np.ones((1, B))
    out = {
        "contact": (n(p.F), n(p.b), n(p.mu), np.zeros((nrow, B))),
        "random": (
            0.5 * rng.randn(nrow, 9, B),
            rng.randn(nrow, B),
            mu_r,
            0.1 * np.abs(rng.randn(nrow, B)),
        ),
    }
    assert np.abs(out["contact"][1]).max() > 0, "no active contact rows"
    return je.meta, te.meta, out


def _both(problems, case):
    jm, tm, out = problems
    F, b, mu, z0 = out[case]
    return jm, tm, [jnp.asarray(x) for x in (F, b, mu, z0)], [
        t64(x) for x in (F, b, mu, z0)]


@pytest.mark.parametrize("case", CASES)
def test_apgd_plain_matches_jax(problems, case):
    jm, tm, (F, b, mu, z0), (tF, tb, tmu, tz0) = _both(problems, case)
    want = jlcp._apgd(jm, F, 0.0, b, mu, z0)
    got = lcp_cuda.apgd_plain(tm, tF, 0.0, tb, tmu, tz0)
    np.testing.assert_allclose(n(got), n(want), atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("case", CASES)
def test_apgd_plain_matches_pallas_kernel_interpreted(problems, case):
    """The TPU kernel body, run by Pallas' interpreter on whole arrays."""
    from jax.experimental import pallas as pl

    jm, tm, (F, b, mu, z0), (tF, tb, tmu, tz0) = _both(problems, case)
    nrow, r, _ = F.shape
    isf, Sel, lo, hi = lcp_pallas._static_rows(jm, F.dtype)
    kernel = functools.partial(
        lcp_pallas._apgd_kernel, r=r, iterations=int(jm.iterations), cfm=0.0
    )
    z_k = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((nrow, B), F.dtype),
        interpret=True,
    )(*[F[:, j, :] for j in range(r)], b, mu, z0, isf[:, None], Sel,
      lo[:, None], hi[:, None])
    got = lcp_cuda.apgd_plain(tm, tF, 0.0, tb, tmu, tz0)
    np.testing.assert_allclose(n(got), n(z_k), atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("case", CASES)
def test_pgd_step_matches_tpu_reattached_step(problems, case):
    """pgd_step against the step apgd_seed_tpu re-attaches to the Pallas
    kernel's output (lcp_pallas.py:267-274), written out here with the JAX
    package's helpers, taken from the APGD seed."""
    jm, tm, (F, b, mu, z0), (tF, tb, tmu, tz0) = _both(problems, case)
    jz = jlcp._apgd(jm, F, 0.0, b, mu, z0)
    isf = jnp.asarray(jm.is_friction)[:, None]
    fidx = np.maximum(jm.findex, 0)
    lo_c, hi_c = jlcp._const_bounds(jm, F.dtype)
    step = 1.0 / (4.0 * jnp.max(jlcp._diag_A(F, 0.0), axis=0) + 1e-9)
    y = jz - step[None, :] * (jlcp._Av(F, 0.0, jz) - b)
    zn = jnp.where(isf, y, jnp.clip(y, lo_c, hi_c))
    bound = mu * jnp.maximum(zn[fidx], 0.0)
    want = jnp.where(isf, jnp.clip(y, -bound, bound), zn)
    got = lcp_cuda.pgd_step(tm, tF, 0.0, tb, tmu, t64(n(jz)))
    np.testing.assert_allclose(n(got), n(want), atol=1e-10, rtol=1e-10)
    assert np.abs(n(want) - n(jz)).max() > 1e-6, "the step did not move z"


@pytest.mark.parametrize("case", CASES)
def test_classify_and_refine_match_jax(problems, case):
    jm, tm, (F, b, mu, z0), (tF, tb, tmu, tz0) = _both(problems, case)
    jz = jlcp._apgd(jm, F, 0.0, b, mu, z0)
    tz = t64(n(jz))
    jmask = jlcp._classify(jm, F, 0.0, b, mu, jz)
    tmask = tlcp._classify(tm, tF, 0.0, tb, tmu, tz)
    for a, c in zip(tmask, jmask):
        np.testing.assert_array_equal(n(a), n(c))
    js, ts = jnp.sign(jz), torch.sign(tz)
    jr = jlcp._refine_masks(jm, F, 0.0, b, mu, *jmask[:2], js, jmask[2])
    tr = tlcp._refine_masks(tm, tF, 0.0, tb, tmu, *tmask[:2], ts, tmask[2])
    for a, c in zip(tr, jr):
        np.testing.assert_array_equal(n(a), n(c))


@pytest.mark.parametrize("cfm", [0.0, 1e-4], ids=["cfm0", "woodbury"])
@pytest.mark.parametrize("case", CASES)
def test_pinned_solve_and_valid_match_jax(problems, case, cfm):
    jm, tm, (F, b, mu, z0), (tF, tb, tmu, tz0) = _both(problems, case)
    jz = jlcp._apgd(jm, F, 0.0, b, mu, z0)
    c, up, hi = jlcp._classify(jm, F, 0.0, b, mu, jz)
    s = jnp.sign(jz)
    want = jlcp._pinned_solve(jm, F, cfm, b, mu, c, up, s, at_hi=hi)
    got = tlcp._pinned_solve(
        tm, tF, cfm, tb, tmu, *[torch.as_tensor(np.array(n(x))) for x in (c, up)],
        t64(n(s)), at_hi=torch.as_tensor(np.array(n(hi))),
    )
    np.testing.assert_allclose(n(got), n(want), atol=1e-7, rtol=1e-7)
    np.testing.assert_array_equal(
        n(tlcp._lcp_valid(tm, tF, cfm, tb, tmu, got)),
        n(jlcp._lcp_valid(jm, F, cfm, b, mu, want)),
    )


@pytest.mark.parametrize("case", CASES)
def test_boxed_lcp_b_matches_jax(problems, case):
    jm, tm, (F, b, mu, z0), (tF, tb, tmu, tz0) = _both(problems, case)
    kw = dict(cfm=0.0, fallback_cfm=1e-4, fallback_gradients=False,
              ladder_mode="always")
    want = jlcp.boxed_lcp_b(jm, F, b, mu, z0, **kw)
    got = tlcp.boxed_lcp_b(tm, tF, tb, tmu, tz0, **kw)
    np.testing.assert_allclose(n(got), n(want), atol=1e-7, rtol=1e-7)
    if case == "contact":
        assert np.abs(n(got)).max() > 0


def test_apgd_seed_on_cpu_takes_plain_path(problems):
    jm, tm, out = problems
    tF, tb, tmu, tz0 = [t64(x) for x in out["contact"]]
    before = lcp_cuda.apgd_seed.launches
    got = lcp_cuda.apgd_seed(tm, tF, tb, tmu, tz0, 0.0)
    assert lcp_cuda.apgd_seed.launches == before == 0
    np.testing.assert_array_equal(
        n(got), n(lcp_cuda.apgd_plain(tm, tF, 0.0, tb, tmu, tz0)))


def test_unsupported_solver_options_raise(problems):
    """Ladder modes and fallback-gradient rules the port does not know
    raise instead of running something else (the default config, solver
    "pgs" and both fallback-gradient rules run: tests/test_torch_pgs.py;
    an unknown solver name runs PGS, as in the JAX package: below)."""
    jm, tm, out = problems
    args = [t64(x) for x in out["contact"]]
    with pytest.raises(ValueError, match="ladder_mode"):
        tlcp.boxed_lcp_b(tm, *args, ladder_mode="deferred")
    with pytest.raises(ValueError, match="fallback_gradients"):
        tlcp.boxed_lcp_b(tm, *args, fallback_gradients="approximate")


@pytest.mark.parametrize("case", CASES)
def test_unknown_solver_name_runs_pgs(problems, case):
    """An LcpMeta.solver other than "apgd" seeds with meta.iterations PGS
    sweeps, as the JAX package's boxed_lcp_b does for every such name:
    the port's seed against the JAX _pgs (2 sweeps, under one jax.jit), and
    the port's impulses equal to those of solver "pgs"."""
    import dataclasses

    jm, tm, (F, b, mu, z0), targs = _both(problems, case)
    jm3 = dataclasses.replace(jm, solver="dantzig", iterations=2)
    tm3 = dataclasses.replace(tm, solver="dantzig", iterations=2)
    want = jax.jit(functools.partial(jlcp._pgs, jm3, cfm=0.0))(F=F, b=b, mu=mu, z0=z0)
    got, z_kernel = tlcp._seed(tm3, *targs, 0.0)
    assert z_kernel is None
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-10, rtol=1e-10)
    assert not np.allclose(n(got), n(targs[3]))
    z3 = tlcp.boxed_lcp_b(tm3, *targs)
    z_pgs = tlcp.boxed_lcp_b(dataclasses.replace(tm3, solver="pgs"), *targs)
    assert torch.equal(z3, z_pgs) and torch.isfinite(z3).all()

"""The port's PGS polish and default-config LCP against the JAX package's,
float64 on the CPU.

* The CPU seed under the default meta (apgd_plain, then 16 sweeps of
  pgs_plain) against the JAX package's pure seed _pgs(_apgd(...))
  (lcp_pallas.py:240-247), on the half-cheetah row plan (n=60, r=9, B=8)
  padded with inert rows to 97, where _pgs rolls its row loop;
* pgs_plain against the TPU kernel body lcp_pallas._apgd_kernel with
  pgs_sweeps=2, run by Pallas in interpret mode (rank 2), and against
  batched/lcp._pgs, on a small hand-made plan (4 contacts, n=12, r=4):
  the interpreter unrolls every sweep, row and rank;
* boxed_lcp_b under the default knobs (32 APGD iterations, 16 PGS sweeps,
  3 refine rounds, the lazy ladder) and under solver "pgs" against the
  JAX boxed_lcp_b at the function level, on the small plan, and on the
  wedged island of tests/test_lcp_ladder.py, where the ladder fires, in
  both ladder modes and under the three fallback_gradients rules.

JAX is compiled once per function and shape (jax.jit): its op-by-op
dispatch compiles every primitive anew. Its _pgs unrolls up to 96 rows
inside a scan, which at n=60 takes ~9 s to compile; above 96 rows it
rolls the same arithmetic into a loop that compiles in under a second. The seeds agree to
roundoff (1e-10); the pinned solves are ridged normal equations whose
conditioning amplifies the two implementations' summation orders by up
to ~1e10 eps, so impulses from them are held to 1e-7 (as in
tests/test_torch_lcp.py).
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.batched import BatchedEngine as JaxEngine
from nimblephysics_tpu.batched import lcp as jlcp
from nimblephysics_tpu.batched import lcp_pallas
from nimblephysics_tpu.simulation.world import SolverConfig as JaxCfg

from nimblephysics_tpu_torch.batched import lcp as tlcp
from nimblephysics_tpu_torch.batched import lcp_cuda
from nimblephysics_tpu_torch.batched.engine import BatchedEngine
from nimblephysics_tpu_torch.simulation import SolverConfig
from torch_parity import (
    F64,
    batch_states,
    half_cheetah_pair,
    n,
    small_contact_metas,
    small_contact_problem,
    t64,
    wedged_island,
)

B = 8
SEED_TOL = 1e-10
SOLVE_TOL = 1e-7
# The default SolverConfig's LCP knobs.
DEFAULT_KNOBS = dict(iterations=32, seed_pgs_sweeps=16, refine_rounds=3)


# Inert rows that route the JAX pure seed through _pgs's rolled row loop
# (taken above 96 rows, lcp.py:121-149): zero F, b, mu and warm start,
# non-friction, bounds [0, inf). Their diagonal is 0, so PGS leaves them
# at 0 and they add nothing to u = F^T z or to A z of the other rows.
PAD_TO = 97


def _pad(meta, arrays):
    extra = PAD_TO - meta.n
    findex = np.concatenate([meta.findex, np.full(extra, -1, np.int32)])
    bounds = {}
    if meta.lo_const is not None:
        bounds["lo_const"] = np.concatenate([meta.lo_const, np.zeros(extra)])
    if meta.hi_const is not None:
        bounds["hi_const"] = np.concatenate([meta.hi_const, np.full(extra, np.inf)])
    padded = dataclasses.replace(meta, findex=findex, is_friction=findex >= 0, **bounds)
    return padded, [np.concatenate([x, np.zeros((extra,) + x.shape[1:])]) for x in arrays]


@pytest.fixture(scope="module")
def default_seed_problems():
    """The half-cheetah LCP rows under the default SolverConfig ("contact":
    the LCP the port's engine assembles on the ground; "random": a seeded
    F, b, mu, z0), the port's meta, and the JAX pure seed (lcp_pallas.py:
    240-247) on the padded rows, compiled once."""
    jw, tw, q0 = half_cheetah_pair()
    jw.solver, tw.solver = JaxCfg(), SolverConfig()
    je, te = JaxEngine(jw), BatchedEngine(tw, **F64)
    assert te.meta.seed_pgs_sweeps == 16 and te.meta.iterations == 32
    q, v, u = batch_states(q0, B, seed=1, drop=-0.25, spread=0.02)
    p = te.lcp_problem(t64(q), t64(v), t64(u))
    rng = np.random.RandomState(2)
    nrow = te.num_rows
    mu_r = np.where(te.meta.is_friction[:, None], 0.9, 0.0) * np.ones((1, B))
    out = {
        "contact": (n(p.F), n(p.b), n(p.mu), np.zeros((nrow, B))),
        "random": (0.5 * rng.randn(nrow, 9, B), rng.randn(nrow, B), mu_r,
                   0.1 * np.abs(rng.randn(nrow, B))),
    }
    jm, _ = _pad(je.meta, [])
    polish = dataclasses.replace(jm, iterations=jm.seed_pgs_sweeps)

    @jax.jit
    def pure_seed(F, b, mu, z0):
        return jlcp._pgs(polish, F, 0.0, b, mu, jlcp._apgd(jm, F, 0.0, b, mu, z0))

    def padded_seed(arrays):
        z = n(pure_seed(*_pad(je.meta, arrays)[1]))
        assert not z[nrow:].any(), "a padding row moved"
        return z[:nrow]

    return te.meta, out, padded_seed


@pytest.mark.parametrize("case", ["contact", "random"])
def test_cpu_seed_matches_jax_pure_seed(default_seed_problems, case):
    """n=60: the JAX seed runs _pgs's rolled row loop on the padded rows
    (its unrolled loop is held at n=12 below: its 60-row scan takes ~9 s
    to compile)."""
    tm, out, padded_seed = default_seed_problems
    want = padded_seed(out[case])
    tF, tb, tmu, tz0 = [t64(x) for x in out[case]]
    got = lcp_cuda.apgd_seed(tm, tF, tb, tmu, tz0)
    np.testing.assert_allclose(n(got), want, atol=SEED_TOL, rtol=SEED_TOL)
    # The polish moved the APGD iterate: it is not a no-op here.
    apgd = n(lcp_cuda.apgd_plain(tm, tF, 0.0, tb, tmu, tz0))
    assert np.abs(n(got) - apgd).max() > 1e-6


def test_pgs_plain_matches_pallas_kernel_interpreted():
    """K1b's TPU form: the kernel body with pgs_sweeps=2 (APGD, then two
    unrolled Gauss-Seidel sweeps), run by Pallas' interpreter."""
    from jax.experimental import pallas as pl

    jm, tm = small_contact_metas(iterations=2, seed_pgs_sweeps=2)
    F, b, mu, z0 = small_contact_problem(3, B, r=2)
    nrow, r, _ = F.shape
    isf, Sel, lo, hi = lcp_pallas._static_rows(jm, jnp.float64)
    kernel = functools.partial(
        lcp_pallas._apgd_kernel, r=r, iterations=2, cfm=0.0, pgs_sweeps=2,
        isf_rows=tuple(bool(x) for x in jm.is_friction),
        fidx_rows=tuple(int(x) for x in np.maximum(jm.findex, 0)),
    )
    z_k = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((nrow, B), jnp.float64),
        interpret=True,
    )(*[jnp.asarray(F[:, j, :]) for j in range(r)], jnp.asarray(b),
      jnp.asarray(mu), jnp.asarray(z0), isf[:, None], Sel, lo[:, None],
      hi[:, None])
    got = lcp_cuda.seed_plain(tm, t64(F), 0.0, t64(b), t64(mu), t64(z0))
    np.testing.assert_allclose(n(got), n(z_k), atol=SEED_TOL, rtol=SEED_TOL)


@pytest.mark.parametrize("case", ["contact", "boxes_cfm"])
def test_pgs_plain_matches_jax_pgs(case):
    """pgs_plain against batched/lcp._pgs. "boxes_cfm" has finite row
    bounds, cfm > 0 and negative normal warm starts, so friction bounds
    mu z[findex] go negative (the clip then returns the bound)."""
    kw, cfm = dict(iterations=5), 0.0
    if case == "boxes_cfm":
        normal = np.arange(12) % 3 == 0
        kw.update(lo_const=np.where(normal, -0.05, -np.inf),
                  hi_const=np.where(normal, 0.4, np.inf))
        cfm = 1e-3
    jm, tm = small_contact_metas(**kw)
    F, b, mu, z0 = small_contact_problem(4, B, negative_normals=(case == "boxes_cfm"))
    want = jax.jit(jlcp._pgs, static_argnums=0)(jm, F, cfm, b, mu, z0)
    got = lcp_cuda.pgs_plain(tm, t64(F), cfm, t64(b), t64(mu), t64(z0))
    np.testing.assert_allclose(n(got), n(want), atol=SEED_TOL, rtol=SEED_TOL)
    if case == "boxes_cfm":
        normals_of_friction = n(got)[np.maximum(tm.findex, 0)][tm.is_friction]
        assert (normals_of_friction < 0).any(), "no friction row saw a negative bound"


@functools.lru_cache(maxsize=None)
def _jax_boxed_fn(jm, fallback_cfm):
    return jax.jit(lambda *a: jlcp.boxed_lcp_b(
        jm, *a, fallback_cfm=fallback_cfm, return_valid=True))


def _jax_boxed(jm, arrays, fallback_cfm=1e-4):
    """The JAX boxed_lcp_b (lazy ladder, no fallback gradients), compiled
    once per meta, and its per-world flag "pinned solve or seed valid"."""
    z, ok = _jax_boxed_fn(jm, fallback_cfm)(*[jnp.asarray(x) for x in arrays])
    return n(z), n(ok)


@pytest.fixture(scope="module")
def default_knobs_metas():
    return small_contact_metas(**DEFAULT_KNOBS)


@pytest.mark.parametrize("seed", [5, 6])
def test_boxed_lcp_b_default_knobs_matches_jax(default_knobs_metas, seed):
    jm, tm = default_knobs_metas
    arrays = small_contact_problem(seed, B)
    want, _ = _jax_boxed(jm, arrays)  # lazy ladder, no fallback gradients
    got = tlcp.boxed_lcp_b(tm, *[t64(x) for x in arrays])
    np.testing.assert_allclose(n(got), want, atol=SOLVE_TOL, rtol=SOLVE_TOL)
    always = tlcp.boxed_lcp_b(tm, *[t64(x) for x in arrays], ladder_mode="always")
    np.testing.assert_array_equal(n(always), n(got))
    assert np.abs(n(got)).max() > 0


def test_pgs_solver_matches_jax():
    """meta.solver = "pgs": the seed is meta.iterations PGS sweeps (the
    ladder, tested above, is off here)."""
    jm, tm = small_contact_metas(iterations=6, refine_rounds=1, solver="pgs")
    arrays = small_contact_problem(7, B)
    want, _ = _jax_boxed(jm, arrays, fallback_cfm=0.0)
    with mock.patch.object(lcp_cuda, "pgs_plain", wraps=lcp_cuda.pgs_plain) as pgs:
        got = tlcp.boxed_lcp_b(tm, *[t64(x) for x in arrays], fallback_cfm=0.0)
    assert pgs.call_count == 1 and pgs.call_args.args[0] is tm
    np.testing.assert_allclose(n(got), want, atol=SOLVE_TOL, rtol=SOLVE_TOL)


@pytest.fixture(scope="module")
def wedged_jax():
    jm, _, *arrays = wedged_island()
    return _jax_boxed(jm, arrays, fallback_cfm=1e-4)


@pytest.mark.parametrize("fallback_gradients", [False, True, "reclassify"])
@pytest.mark.parametrize("ladder_mode", ["lazy", "always"])
def test_wedged_island_ladder_matches_jax(wedged_jax, ladder_mode, fallback_gradients):
    """Every ladder mode and gradient rule ships the JAX package's
    impulses (the rule changes gradients only)."""
    want, ok = wedged_jax
    _, tm, *arrays = wedged_island()
    got, saved = tlcp.boxed_lcp_b(
        tm, *[t64(x) for x in arrays], fallback_cfm=1e-4,
        fallback_gradients=fallback_gradients, ladder_mode=ladder_mode,
        return_saved=True,
    )
    np.testing.assert_allclose(n(got), want, atol=SOLVE_TOL, rtol=SOLVE_TOL)
    # Worlds 0-1: neither the pinned solve nor the seed is valid, so the
    # lazy ladder fires and a softened rung serves them.
    np.testing.assert_array_equal(ok, [False, False, True, True])
    np.testing.assert_array_equal(n(saved.valid), [False, False, True, True])


@pytest.mark.parametrize("what", ["default", "pgs_solver", "reclassify", "true"])
def test_engine_steps_every_solver_option(what):
    """BatchedEngine takes the default SolverConfig (PGS-polished seed, 3
    refine rounds, lazy ladder), solver "pgs" and both fallback-gradient
    rules, and its step stays finite with impulses on the ground."""
    from nimblephysics_tpu_torch.models import half_cheetah

    world, q0, _ = half_cheetah()
    world.solver = {
        "default": SolverConfig(),
        "pgs_solver": SolverConfig(lcp_solver="pgs"),
        "reclassify": SolverConfig(fallback_gradients="reclassify"),
        "true": SolverConfig(fallback_gradients=True),
    }[what]
    eng = BatchedEngine(world, **F64)
    q, v, u = batch_states(np.asarray(q0, np.float64), 2, seed=6, drop=-0.25)
    r = eng.step(t64(q), t64(v), t64(u))
    for x in (r.q, r.v, r.impulses):
        assert torch.isfinite(x).all()
    assert r.impulses.abs().max() > 0

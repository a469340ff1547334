"""Gradients of the port, float64 on the CPU.

* The VJP of the port's _pinned_solve against jax.vjp of the JAX
  package's, on the same masks and cotangent: cfm = 0 and the Woodbury
  rung on a small contact plan (4 contacts, n=12, rank 2: the JAX solve's
  compile grows with the rank); and on the wedged
  island of tests/test_lcp_ladder.py, the port's boxed_lcp_b gradient
  under fallback_gradients True and "reclassify" against the JAX VJP of
  the softened pinned solve each rule differentiates there. The gradient
  of boxed_lcp_b is that of these solves on masks the forward tests hold
  equal (tests/test_torch_lcp.py, tests/test_torch_pgs.py), so the JAX
  boxed_lcp_b itself is not differentiated here.
* BatchedEngine.step's VJP against central finite differences of the
  port's own step, in the air and on the ground with a fixed active set.
* remat_step against step over a warm-started rollout: the same
  gradients, and its backward never runs the seed.
* train_step_batched's loss gradient against finite differences, and its
  loss falls over a few steps on the same start; policy_from_arrays
  against bench.py's policy.

Tolerances: the JAX and port pinned solves differ by roundoff amplified
by the ridged normal equations (~1e10 eps, tests/test_torch_lcp.py), so
their VJPs are held to 1e-6 of the largest entry. The pinned solve of a
rank-deficient active set (relative ridge 1e-10) amplifies the roundoff
of a central difference by ~1e10 too: at the ground state below its
difference quotient moves off the gradient by 2e-6 (relative) at a step
of 1e-4, 2e-5 at 1e-5 and 2e-4 at 1e-6. So the differences take a step
of 1e-4, check that no active set changes within it, and are held to
1e-4 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from nimblephysics_tpu.batched import lcp as jlcp

from nimblephysics_tpu_torch.batched import lcp as tlcp
from nimblephysics_tpu_torch.batched import lcp_cuda
from nimblephysics_tpu_torch.batched.engine import BatchedEngine
from nimblephysics_tpu_torch.convert import policy_from_arrays
from nimblephysics_tpu_torch.models import half_cheetah
from nimblephysics_tpu_torch.parallel import MlpPolicy, train_step_batched
from nimblephysics_tpu_torch.simulation import SolverConfig
from torch_parity import (
    F64,
    batch_states,
    n,
    small_contact_metas,
    small_contact_problem,
    t64,
    wedged_island,
)

WEDGED = wedged_island()  # one meta object, so JAX compiles its VJP once
VJP_TOL = 1e-6
FD_TOL = 1e-4
H = 1e-4
SOFT = 1e-4


def _close(got, want, tol):
    got, want = n(got), n(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _vjp_torch(fn, arrays, cot):
    """fn(F, b, mu) -> z; the gradient of <cot, z> in (F, b, mu)."""
    xs = [t64(x).requires_grad_() for x in arrays]
    z = fn(*xs)
    return z, torch.autograd.grad((z * t64(cot)).sum(), xs)


# -- pinned solve, small plan ----------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_pinned_vjp(jm, cfm):
    """jax.vjp of the JAX _pinned_solve in (F, b, mu) at fixed masks,
    compiled once per meta and cfm. mu_keep marks the worlds whose mu
    carries gradient (the "reclassify" rung stops it elsewhere)."""

    @jax.jit
    def vjp(F, b, mu, mu_keep, masks, cot):
        def solve(F, b, mu):
            mu_g = jnp.where(mu_keep[None, :], mu, jax.lax.stop_gradient(mu))
            return jlcp._pinned_solve(jm, F, cfm, b, mu_g, *masks[:3],
                                      at_hi=masks[3])

        z, back = jax.vjp(solve, F, b, mu)
        return z, back(cot)

    return vjp


def _jax_vjp(jm, cfm, arrays, masks, cot, mu_keep=None):
    B = arrays[1].shape[1]
    keep = np.ones(B, bool) if mu_keep is None else n(mu_keep)
    return _jax_pinned_vjp(jm, cfm)(
        *[jnp.asarray(x) for x in arrays], jnp.asarray(keep),
        tuple(jnp.asarray(n(m)) for m in masks), jnp.asarray(cot))


@pytest.fixture(scope="module")
def small_plan_vjps():
    """Small contact plan, masks classified from the APGD seed, and the JAX
    VJPs of its pinned solve at cfm = 0 and at the Woodbury rung's cfm,
    compiled as one function."""
    jm, tm = small_contact_metas(iterations=24, seed_pgs_sweeps=0)
    F, b, mu, z0 = small_contact_problem(11, 8, r=2)
    tF, tb, tmu = t64(F), t64(b), t64(mu)
    z = lcp_cuda.seed_plain(tm, tF, 0.0, tb, tmu, t64(z0))
    c, up, hi = tlcp._classify(tm, tF, 0.0, tb, tmu, z)
    assert n(c).any() and (~n(c)).any(), "the active set must be mixed"
    masks = (c, up, torch.sign(z), hi)
    cot = np.random.RandomState(12).randn(*b.shape)

    @jax.jit
    def both(F, b, mu, masks, cot):
        out = {}
        for name, cfm in (("cfm0", 0.0), ("woodbury", SOFT)):
            z, back = jax.vjp(lambda F, b, mu: jlcp._pinned_solve(
                jm, F, cfm, b, mu, *masks[:3], at_hi=masks[3]), F, b, mu)
            out[name] = (z, back(cot))
        return out

    want = both(*[jnp.asarray(x) for x in (F, b, mu)],
                tuple(jnp.asarray(n(m)) for m in masks), jnp.asarray(cot))
    return tm, (F, b, mu), masks, cot, want


@pytest.mark.parametrize("case", ["cfm0", "woodbury"])
def test_pinned_solve_vjp_matches_jax(small_plan_vjps, case):
    tm, arrays, masks, cot, want = small_plan_vjps
    cfm = 0.0 if case == "cfm0" else SOFT
    got_z, got = _vjp_torch(
        lambda F, b, mu: tlcp._pinned_solve(tm, F, cfm, b, mu, *masks[:3],
                                            at_hi=masks[3]),
        arrays, cot)
    want_z, want_g = want[case]
    _close(got_z, want_z, VJP_TOL)
    for g, w in zip(got, want_g):
        _close(g, w, VJP_TOL)


# -- the ladder's gradient rules on the wedged island ----------------------


@pytest.mark.parametrize("fallback_gradients", [False, True, "reclassify"])
@pytest.mark.parametrize("ladder_mode", ["lazy", "always"])
def test_ladder_gradients_match_jax_rungs(ladder_mode, fallback_gradients):
    """Worlds the ladder serves (0-1; neither their pinned solve nor their
    seed is valid, the cfm-softened rung is): no impulse gradient under
    False; under True the VJP of the softened pinned solve on the refined
    masks; under "reclassify" that of the softened pinned solve on the
    masks of the ladder's own impulse, mu carrying gradient only where
    the softened rung is valid (lcp.py:505-526). The same in either
    ladder mode: the lazy ladder fires here. The cotangent lives on
    worlds 0-1."""
    jm, tm, F, b, mu, z0 = WEDGED
    cot = np.random.RandomState(13).randn(*b.shape)
    cot[:, 2:] = 0.0
    _, got = _vjp_torch(
        lambda F, b, mu: tlcp.boxed_lcp_b(
            tm, F, b, mu, t64(z0), fallback_cfm=SOFT,
            fallback_gradients=fallback_gradients, ladder_mode=ladder_mode),
        (F, b, mu), cot)
    if fallback_gradients is False:
        for g in got:
            assert float(g.abs().max()) == 0.0
        return
    _, s = tlcp.boxed_lcp_b(
        tm, *[t64(x) for x in (F, b, mu, z0)], fallback_cfm=SOFT,
        fallback_gradients=fallback_gradients, return_saved=True)
    assert not n(s.valid)[:2].any() and not n(s.valid_seed)[:2].any()
    assert n(s.valid_soft)[:2].all()
    if fallback_gradients is True:
        masks, keep = (s.clamping, s.upper, s.sign_u, s.at_hi), None
    else:
        masks, keep = s.reclassified, s.valid_soft
    _, want = _jax_vjp(jm, SOFT, (F, b, mu), masks, cot, mu_keep=keep)
    for g, w in zip(got, want):
        _close(g, w, VJP_TOL)
    assert float(got[0].abs().max()) > 0


# -- BatchedEngine.step against finite differences ------------------------


def _engine(cfg=None):
    world, q0, _ = half_cheetah()
    world.solver = cfg or SolverConfig()
    return BatchedEngine(world, **F64), np.asarray(q0, np.float64)


@pytest.mark.parametrize("drop", [0.3, -0.26], ids=["air", "ground"])
def test_step_vjp_matches_finite_differences(drop):
    """Default SolverConfig (K1b's plain version on the path), 2 worlds.
    On the ground every world's pinned solve is valid and the masks are
    the same at x and x +- h d, so the step is smooth along d."""
    eng, q0 = _engine()
    q, v, u = batch_states(q0, 2, seed=24, drop=drop)
    rng = np.random.RandomState(22)
    wq, wv = t64(rng.randn(*q.shape)), t64(rng.randn(*v.shape))
    x = [t64(a).requires_grad_() for a in (q, v, u)]
    r = eng.step(*x)
    grads = torch.autograd.grad((wq * r.q).sum() + (wv * r.v).sum(), x)

    def loss_and_saved(q, v, u):
        p = eng.lcp_problem(q, v, u)
        z, saved = tlcp.boxed_lcp_b(eng.meta, p.F, p.b, p.mu,
                                    torch.zeros_like(p.b), return_saved=True)
        r = eng._finish(q, v, p, z)
        return float((wq * r.q).sum() + (wv * r.v).sum()), saved, z

    L0, s0, z0 = loss_and_saved(*[t64(a) for a in (q, v, u)])
    if drop < 0:
        assert float(z0.abs().max()) > 0 and bool(s0.valid.all())
    else:
        assert float(z0.abs().max()) == 0
    for k in range(2):
        d = [rng.randn(*a.shape) for a in (q, v, u)]
        side = []
        for sgn in (1.0, -1.0):
            L, s, _ = loss_and_saved(*[t64(a + sgn * H * da) for a, da in zip((q, v, u), d)])
            for a, c in zip(s[2:7], s0[2:7]):
                assert torch.equal(a, c), "the active set moved within the difference"
            side.append(L)
        fd = (side[0] - side[1]) / (2 * H)
        ad = sum(float((g * t64(da)).sum()) for g, da in zip(grads, d))
        assert abs(fd - ad) <= FD_TOL * abs(ad), (fd, ad)


# -- remat_step --------------------------------------------------------------


@pytest.mark.parametrize("cfg", ["default", "throughput"])
def test_remat_rollout_matches_plain_and_skips_the_seed(cfg):
    """Two warm-started steps on the ground: remat_step gives step's
    values and gradients, and its backward calls the seed zero times (the
    forward calls it once a step)."""
    eng, q0 = _engine(SolverConfig() if cfg == "default" else SolverConfig.throughput())
    q, v, _ = batch_states(q0, 2, seed=31, drop=-0.25)
    us = [t64(0.3 * np.random.RandomState(32 + k).randn(*q.shape)) for k in range(2)]
    results = {}
    for name in ("step", "remat_step"):
        fn = getattr(eng, name)
        x = [t64(q).requires_grad_(), t64(v).requires_grad_()] + [
            u.clone().requires_grad_() for u in us]
        with mock.patch.object(lcp_cuda, "apgd_seed", wraps=lcp_cuda.apgd_seed) as seed:
            qq, vv, z, loss = x[0], x[1], None, 0.0
            for u in x[2:]:
                r = fn(qq, vv, u, z_warm=z)
                qq, vv, z = r.q, r.v, r.impulses
                loss = loss + (vv * vv).sum() + qq[1].sum()
            forward_calls = seed.call_count
            grads = torch.autograd.grad(loss, x)
            backward_calls = seed.call_count - forward_calls
        assert forward_calls == 2 and backward_calls == 0
        assert float(z.detach().abs().max()) > 0
        results[name] = (loss.detach(), grads)
    (l0, g0), (l1, g1) = results["step"], results["remat_step"]
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


# -- the training step -------------------------------------------------------


def _train_setup(B=4, hidden=8):
    eng, q0 = _engine()
    nv = eng.world.num_dofs
    rng = np.random.RandomState(42)
    x0 = np.concatenate([q0, np.zeros(nv)])
    states = np.tile(x0[:, None], (1, B)) + 0.01 * rng.randn(2 * nv, B)
    states[1] -= 0.26  # feet within the contact clipping depth
    policy = MlpPolicy(2 * nv, eng.world.action_size, hidden, seed=3, **F64)
    return eng, t64(states), policy


def _recorded_active_sets(fn):
    """Run fn(); return its value and, per LCP solved, the masks and the
    validity flags (LcpSaved fields clamping..valid)."""
    seen = []
    ladder = tlcp._ladder

    def record(*args, **kw):
        saved = ladder(*args, **kw)
        seen.append(saved[2:7])
        return saved

    with mock.patch.object(tlcp, "_ladder", record):
        out = fn()
    return out, seen


def test_train_step_gradient_matches_finite_differences():
    """B=4, horizon 2, hidden 8, default SolverConfig, feet on the ground.
    Every LCP of the rollout is solved by its pinned solve (no world
    falls to the ladder, which carries no gradient), and no active set
    changes within the difference."""
    eng, states, policy = _train_setup()
    train = train_step_batched(eng, policy, horizon=2, learning_rate=0.0)
    loss0, sets0 = _recorded_active_sets(lambda: train(states).loss)
    assert all(bool(s[4].all()) and bool(s[0].any()) for s in sets0)
    picks = [(policy.w1, (0, 9)), (policy.b2, (3, 0))]
    grads = [float(p.grad[i]) for p, i in picks]
    assert all(np.isfinite(g) for g in grads) and all(g != 0 for g in grads)
    for (p, i), g in zip(picks, grads):
        side = []
        for sgn in (1.0, -1.0):
            with torch.no_grad():
                p[i] += sgn * H
            loss, sets = _recorded_active_sets(lambda: float(train(states).loss))
            with torch.no_grad():
                p[i] -= sgn * H
            for s, s0 in zip(sets, sets0):
                assert all(torch.equal(a, c) for a, c in zip(s, s0)), \
                    "an active set moved within the difference"
            side.append(loss)
        fd = (side[0] - side[1]) / (2 * H)
        assert abs(fd - g) <= FD_TOL * abs(g), (fd, g)
    assert float(train(states).loss) == float(loss0)


def test_train_step_learns():
    """dryrun_multichip's check: on the same start the loss falls."""
    eng, states, policy = _train_setup()
    train = train_step_batched(eng, policy, horizon=2, learning_rate=5e-2)
    losses = [float(train(states).loss) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_train_step_rejects_a_policy_elsewhere():
    eng, _, _ = _train_setup()
    policy = MlpPolicy(18, 6, 8, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="float64"):
        train_step_batched(eng, policy)


def test_policy_from_arrays_matches_bench_policy():
    """bench.py:118-120's policy on the same numpy weights, JAX eager."""
    rng = np.random.RandomState(51)
    p = {"w1": 0.1 * rng.randn(64, 18), "b1": rng.randn(64, 1),
         "w2": 0.1 * rng.randn(6, 64), "b2": rng.randn(6, 1)}
    s = rng.randn(18, 5)
    h = jnp.tanh(jnp.asarray(p["w1"]) @ jnp.asarray(s) + jnp.asarray(p["b1"]))
    want = jnp.asarray(p["w2"]) @ h + jnp.asarray(p["b2"])
    policy = policy_from_arrays(p["w1"], p["b1"], p["w2"], p["b2"], **F64)
    np.testing.assert_allclose(n(policy(t64(s))), n(want), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="shape"):
        policy_from_arrays(p["w1"], p["b1"], p["w2"], p["b2"][:3], **F64)

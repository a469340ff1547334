"""Constraint islands and the contact cap in the port, float64 on the CPU.

* The plans against the JAX package's (numpy only, no compile): the
  island partition (rows, dofs and row plan of each island) of
  tests/test_islands.py's scene, and the capped row plan of the 3- and
  5-box stacks.
* The port against itself at the JAX package's own tolerances
  (tests/test_islands.py:91-137, tests/test_contact_cap.py:69-100): an
  islanded step equals the monolithic one, a capped step the full one,
  and their VJPs agree; remat_step replays them without the seed or the
  cap's top-k.

The capped step equals the full one only where no world has more
penetrating slots than the cap. The tests assert that every world has at
most `cap` slots with 0 < depth <= the clipping depth: then every such
slot is picked whatever the order among ties, and the slots left to tie
(score -1) carry no rows. Ties are broken towards the lower slot, as
jax.lax.top_k does; test_cap_rows_break_ties_as_top_k holds that.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.batched import BatchedEngine as JaxEngine

from nimblephysics_tpu_torch.batched import BatchedEngine, lcp_cuda
from nimblephysics_tpu_torch.batched import engine as tengine
from torch_parity import F64, box_stack_pair, islands_scene, n, t64

B = 4


def _meta_equal(tm, jm):
    np.testing.assert_array_equal(tm.findex, jm.findex)
    np.testing.assert_array_equal(tm.is_friction, jm.is_friction)
    for f in ("lo_const", "hi_const"):
        a, b = getattr(tm, f), getattr(jm, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for f in ("iterations", "tol", "ridge", "refine_rounds", "seed_pgs_sweeps",
              "k_active", "solver"):
        assert getattr(tm, f) == getattr(jm, f), f


def test_island_plan_matches_jax():
    jw, tw, _ = islands_scene(3)
    je, te = JaxEngine(jw), BatchedEngine(tw, **F64)
    assert je.islands is not None and te.islands is not None
    assert len(te.islands) == len(je.islands) == 3
    for (tr, td, tm), (jr, jd, jm) in zip(te.islands, je.islands):
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(td, jd)
        _meta_equal(tm, jm)
        assert (tm.n, len(td)) == (24, 6)
    assert te.contact_cap is None and te.meta_cap is None


@pytest.mark.parametrize("n_boxes,cap", [(3, 16), (5, 48)])
def test_cap_plan_matches_jax(n_boxes, cap):
    jw, tw, _ = box_stack_pair(n_boxes, contact_cap=cap)
    je, te = JaxEngine(jw), BatchedEngine(tw, **F64)
    assert te.islands is None and je.islands is None
    assert te.contact_cap == je.contact_cap == cap
    _meta_equal(te.meta_cap, je.meta_cap)
    assert te.meta_cap.n == 3 * cap
    # A cap at or above the slot count selects nothing.
    _, tw, _ = box_stack_pair(n_boxes, contact_cap=1000)
    assert BatchedEngine(tw, **F64).contact_cap is None


def _pair(world, **solver):
    """(engine with world's solver, engine with solver fields replaced)."""
    base = BatchedEngine(world, **F64)
    cfg = world.solver
    world.solver = dataclasses.replace(cfg, **solver)
    try:
        other = BatchedEngine(world, **F64)
    finally:
        world.solver = cfg
    return base, other


def _loss(r):
    return (r.q**2).sum() + (r.v**2).sum()


def _vjp(eng, q, v, fn="step"):
    x = [t64(q).requires_grad_(), t64(v).requires_grad_()]
    r = getattr(eng, fn)(*x, torch.zeros_like(x[0]))
    return torch.autograd.grad(_loss(r), x)


def test_island_step_matches_monolithic():
    _, tw, q = islands_scene(3)
    eng_i, eng_m = _pair(tw, contact_islands=False)
    assert eng_i.islands is not None and eng_m.islands is None
    rng = np.random.default_rng(0)
    qb = np.tile(q[:, None], (1, B)) + 0.003 * rng.standard_normal((18, B))
    vb = 0.05 * rng.standard_normal((18, B))
    u = t64(np.zeros((18, B)))
    r_i = eng_i.step(t64(qb), t64(vb), u)
    r_m = eng_m.step(t64(qb), t64(vb), u)
    np.testing.assert_allclose(n(r_i.q), n(r_m.q), atol=1e-9, rtol=0)
    np.testing.assert_allclose(n(r_i.v), n(r_m.v), atol=5e-6, rtol=0)
    np.testing.assert_allclose(n(r_i.impulses), n(r_m.impulses), atol=5e-6, rtol=0)
    assert np.abs(n(r_i.impulses)).max() > 0
    # Warm-started again on the island path: finite.
    r2 = eng_i.step(r_i.q, r_i.v, u, z_warm=r_i.impulses)
    assert torch.isfinite(r2.q).all()


def test_island_gradients_match_monolithic():
    _, tw, q = islands_scene(2)
    eng_i, eng_m = _pair(tw, contact_islands=False)
    qb, vb = np.tile(q[:, None], (1, 2)), np.zeros((12, 2))
    for a, b in zip(_vjp(eng_i, qb, vb), _vjp(eng_m, qb, vb)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=1e-6)


def _cap_batch(q0, worlds, seed):
    """tests/test_contact_cap.py's _batch: q0 jittered by 2 mm, v by 0.02."""
    rng = np.random.default_rng(seed)
    nv = len(q0)
    q = np.tile(q0[:, None], (1, worlds)) + 0.002 * rng.standard_normal((nv, worlds))
    return q, 0.02 * rng.standard_normal((nv, worlds))


def _unsaturated(eng, q, v, cap):
    p = eng.lcp_problem(t64(q), t64(v), t64(np.zeros_like(q)))
    d = p.contact_depths
    live = ((d > 0) & (d <= eng.world.solver.contact_clipping_depth)).sum(dim=0)
    assert int(live.max()) <= cap, "a world has more penetrating slots than the cap"
    assert int(live.min()) > 0


def test_cap_step_matches_full_solve():
    _, tw, q0 = box_stack_pair(3)
    eng_f, eng_c = _pair(tw, contact_cap=16)
    assert eng_c.contact_cap == 16 and eng_f.contact_cap is None
    q, v = _cap_batch(q0, B, 0)
    _unsaturated(eng_f, q, v, 16)
    u = t64(np.zeros_like(q))
    r_f = eng_f.step(t64(q), t64(v), u)
    r_c = eng_c.step(t64(q), t64(v), u)
    np.testing.assert_allclose(n(r_c.q), n(r_f.q), atol=1e-12, rtol=0)
    np.testing.assert_allclose(n(r_c.v), n(r_f.v), atol=5e-6, rtol=0)
    np.testing.assert_allclose(n(r_c.impulses), n(r_f.impulses), atol=5e-6, rtol=0)
    assert np.abs(n(r_c.impulses)).max() > 0


def test_cap_gradients_match_full_solve():
    _, tw, q0 = box_stack_pair(2)
    eng_f, eng_c = _pair(tw, contact_cap=12)
    q, v = _cap_batch(q0, 2, 0)
    _unsaturated(eng_f, q, v, 12)
    for a, b in zip(_vjp(eng_c, q, v), _vjp(eng_f, q, v)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("scene", ["islands", "cap"])
def test_remat_replays_without_seed_or_top_k(scene):
    """remat_step gives step's values and gradients; its backward runs
    neither the seed (one call per island or capped LCP in the forward)
    nor the cap's slot selection."""
    if scene == "islands":
        _, tw, q = islands_scene(3)
        eng, lcps = BatchedEngine(tw, **F64), 3
        qb, vb = np.tile(q[:, None], (1, 2)), np.zeros((18, 2))
    else:
        _, tw, q0 = box_stack_pair(3, contact_cap=16)
        eng, lcps = BatchedEngine(tw, **F64), 1
        qb, vb = _cap_batch(q0, 2, 1)
    grads = {}
    for fn in ("step", "remat_step"):
        with mock.patch.object(lcp_cuda, "apgd_seed", wraps=lcp_cuda.apgd_seed) as seed, \
                mock.patch.object(eng, "_cap_rows", wraps=eng._cap_rows) as rows:
            x = [t64(qb).requires_grad_(), t64(vb).requires_grad_()]
            r = getattr(eng, fn)(*x, torch.zeros_like(x[0]))
            fwd = (seed.call_count, rows.call_count)
            grads[fn] = torch.autograd.grad(_loss(r), x)
            bwd = (seed.call_count - fwd[0], rows.call_count - fwd[1])
        assert fwd == (lcps, int(scene == "cap")) and bwd == (0, 0), (fn, fwd, bwd)
    for a, b in zip(grads["step"], grads["remat_step"]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_cap_rows_break_ties_as_top_k():
    """Equal scores (the corners of a level face, the -1 of every slot
    out of contact) go to the lower slot, as jax.lax.top_k picks them;
    the picked slots come back in slot order, three rows each."""
    _, tw, _ = box_stack_pair(3, contact_cap=16)
    eng = BatchedEngine(tw, **F64)
    C = eng.bcollider.num_contacts
    rng = np.random.RandomState(3)
    depth = np.where(rng.rand(C, B) < 0.4, 0.001 * rng.randint(1, 4, (C, B)), -0.5)
    depth[:12, 0] = 0.002  # more ties than the cap can take
    rows = n(eng._cap_rows(t64(depth)))
    score = np.where((depth > 0) & (depth <= 0.03), depth, -1.0)
    _, slots = jax.lax.top_k(jnp.asarray(score.T), 16)
    want = np.sort(np.asarray(slots), axis=1)
    want_rows = (3 * want[:, :, None] + np.arange(3)).reshape(B, -1).T
    np.testing.assert_array_equal(rows, want_rows)

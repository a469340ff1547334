"""nimblephysics_tpu_torch's trajectory layer (trajectory/problem.py,
trajectory/optimizers.py) against the JAX package, float64 on the CPU.

* Cartpole (the JAX tests' world, action on the cart): SingleShot and
  MultiShot (2 shots x 5 steps) rollouts, loss, constraints and the loss
  gradient at 1e-10; the constraint, final-state and terminal-residual
  Jacobians at 1e-9, and the per-step (scan) forms against the reverse
  pass through the whole rollout in the port itself; pinned forces and a
  per-mapping loss; the first iterates of SGDOptimizer and of the
  augmented Lagrangian's inner loop at 1e-8. The JAX side of each is one
  jax.jit, compiled once in a module fixture.
* The JAX tests' own end criteria on the port's optimisers, on the
  cartpole at a time step of 0.05 and fewer steps, to keep each test to
  seconds (the port's single-world step takes ~30 ms with its gradient on
  a CPU core): SGD to 5% of the start loss, SLSQP to a knot violation of
  1e-4 and a fifth of the start loss, the augmented Lagrangian to a knot
  violation of 1e-4, Gauss-Newton reducing the loss tenfold at 1e-4
  feasibility.
* Half-cheetah in shallow contact (live contact rows every step):
  MultiShot 2 x 2 forward against JAX at 1e-9 (never jax.grad or jax.jacrev of a
  half-cheetah rollout), the per-step constraint Jacobian against the
  reverse pass through the rollout at 1e-8, and one column block against
  the port's Ridders finite differences at 2e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import cartpole as jax_cartpole
from nimblephysics_tpu.neural.mappings import IKMapping as JaxIK
from nimblephysics_tpu.trajectory import AugmentedLagrangianOptimizer as JaxAL
from nimblephysics_tpu.trajectory import MultiShot as JaxMultiShot
from nimblephysics_tpu.trajectory import SGDOptimizer as JaxSGD
from nimblephysics_tpu.trajectory import SingleShot as JaxSingleShot
from nimblephysics_tpu.trajectory import TerminalResiduals as JaxTR

from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.math import finite_difference_jacobian
from nimblephysics_tpu_torch.neural import IKMapping
from nimblephysics_tpu_torch.trajectory import (
    AugmentedLagrangianOptimizer,
    GaussNewtonOptimizer,
    HostInteriorPointOptimizer,
    MultiShot,
    SGDOptimizer,
    SingleShot,
    TerminalResiduals,
    TrajectoryRollout,
)
from torch_parity import dump_world, n, shallow_cheetah_state, t64

START = np.array([0.0, 0.1, 0.0, 0.0])
# tests/test_trajectory.py's loss: drive the cart to x = 0.3 and stop.
TARGET, W_POS, W_VEL, W_EFF = 0.3, 10.0, 0.1, 1e-5
PIN_T, PIN = 3, np.array([0.37])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: a single-world step is
    thousands of tiny ops, which more threads a process only slow when
    test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_loss(ro):
    qf, vf = ro.poses[-1], ro.vels[-1]
    return W_POS * (qf[0] - TARGET) ** 2 + W_VEL * vf[0] ** 2 + W_EFF * jnp.sum(ro.forces ** 2)


def torch_loss(ro):
    qf, vf = ro.poses[-1], ro.vels[-1]
    return W_POS * (qf[0] - TARGET) ** 2 + W_VEL * vf[0] ** 2 + W_EFF * torch.sum(ro.forces ** 2)


def jax_terminal(final, forces):
    return jnp.concatenate([3.0 * final[:2], 0.1 * final[2:], 0.01 * forces.reshape(-1)])


def torch_terminal(final, forces):
    return torch.cat([3.0 * final[:2], 0.1 * final[2:], 0.01 * forces.reshape(-1)])


def jax_pole_loss(ro):
    return jnp.sum((ro.mapped["pole"]["pos"][-1, 0] - 0.2) ** 2)


def torch_pole_loss(ro):
    return torch.sum((ro.mapped["pole"]["pos"][-1, 0] - 0.2) ** 2)


def cart_pair():
    jw, _, _ = jax_cartpole()
    jw.set_action_space([0])  # force on the cart only
    return jw, world_from_arrays(dump_world(jw))


def problems(jw, tw):
    """{name: (JAX problem, port problem, x)}: SingleShot 10 steps,
    MultiShot 2 x 5, the same MultiShot with a pinned force, and a pinned
    SingleShot with the pole's IK mapping."""
    rng = np.random.RandomState(0)
    out = {}
    for name in ("single", "multi", "multi_pinned", "mapped"):
        if name == "single":
            pj, pt = (JaxSingleShot(jw, jax_loss, 10),
                      SingleShot(tw, torch_loss, 10, device="cpu"))
        elif name == "mapped":
            pj, pt = (JaxSingleShot(jw, jax_pole_loss, 10),
                      SingleShot(tw, torch_pole_loss, 10, device="cpu"))
            jm, tm = JaxIK(jw), IKMapping(tw)
            jm.add_linear_body_node(1)  # the pole's world position
            tm.add_linear_body_node(1)
            pj.add_mapping("pole", jm)
            pt.add_mapping("pole", tm)
        else:
            pj, pt = (JaxMultiShot(jw, jax_loss, 10, 5),
                      MultiShot(tw, torch_loss, 10, 5, device="cpu"))
        if name in ("multi_pinned", "mapped"):
            pj.pin_force(PIN_T, PIN)
            pt.pin_force(PIN_T, PIN)
        x0 = np.asarray(pj.initial_guess(jnp.asarray(START)))
        pt.initial_guess(START)
        x = x0 + 0.2 * rng.randn(x0.size)
        out[name] = (pj, pt, x)
    return out


@pytest.fixture(scope="module")
def cart():
    """The problems and every JAX reading of them, from one jax.jit."""
    jw, tw = cart_pair()
    probs = problems(jw, tw)

    def readings(xs):
        out = {}
        for name in ("mapped", "multi_pinned"):
            pj = probs[name][0]
            x = xs[name]
            ro = pj.rollout(x)
            out[name] = dict(poses=ro.poses, vels=ro.vels, forces=ro.forces,
                             loss=pj.loss(x), grad=jax.grad(pj.loss)(x),
                             constraints=pj.constraints(x))
            if name == "mapped":
                out[name].update(mpos=ro.mapped["pole"]["pos"],
                                 mvel=ro.mapped["pole"]["vel"])
            if name == "multi_pinned":
                tr = JaxTR(pj, jax_terminal)
                out[name].update(jac=pj.constraint_jacobian(x),
                                 jac_scan=pj.constraint_jacobian_scan(x),
                                 final_jac=pj.final_state_jacobian(x),
                                 tr=tr(x), tr_jac=tr.jacobian(x))
        return out

    xs = {k: jnp.asarray(probs[k][2]) for k in ("mapped", "multi_pinned")}
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(readings)(xs))
    return jw, tw, probs, ref


def close(got, want, rtol, atol=None):
    want = np.asarray(want)
    atol = rtol * (1.0 + np.abs(want).max(initial=0.0)) if atol is None else atol
    np.testing.assert_allclose(n(got), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["multi_pinned", "mapped"])
def test_rollout_loss_grad_constraints_match_jax(cart, name):
    """A MultiShot and a SingleShot with a mapping, each with a pinned
    force (the unpinned SingleShot's and MultiShot's gradients are held
    through the optimisers' iterates below)."""
    _, _, probs, ref = cart
    _, pt, x = probs[name]
    r = ref[name]
    xt = t64(x).requires_grad_()
    ro = pt.rollout(xt)
    for key in ("poses", "vels", "forces"):
        close(getattr(ro, key), r[key], 1e-10)
    loss = pt.loss(xt)
    (g,) = torch.autograd.grad(loss, [xt])
    close(loss, r["loss"], 1e-10)
    close(g, r["grad"], 1e-10)
    close(pt.constraints(xt), r["constraints"], 1e-10)
    assert pt.constraints(xt).shape == (pt.num_constraints,)
    if name == "mapped":
        close(ro.mapped["pole"]["pos"], r["mpos"], 1e-10)
        close(ro.mapped["pole"]["vel"], r["mvel"], 1e-10)
        assert ro.mapped["pole"]["pos"].shape == (10, 3)
    if name in ("multi_pinned", "mapped"):
        # Problem::pinForce: the row is the pin and its variables carry
        # exactly no gradient; the others do.
        close(ro.forces[PIN_T], PIN, 0.0, atol=0.0)
        s = (pt.num_variables - pt.steps * pt.na) + PIN_T * pt.na
        assert float(g[s : s + pt.na].abs().max()) == 0.0
        assert float(g.abs().max()) > 0


def test_jacobians_match_jax_and_the_rollout_reverse_pass(cart):
    """The per-step (scan) Jacobians against JAX at 1e-9 and against the
    port's reverse pass through the whole rollout (tests/
    test_atlas_trajectory.py::test_structured_jacobians_match_jacrev)."""
    _, _, probs, ref = cart
    _, pt, x = probs["multi_pinned"]
    r = ref["multi_pinned"]
    xt = t64(x)
    J_scan = pt.constraint_jacobian_scan(xt)
    J_ref = pt.constraint_jacobian(xt)
    close(J_scan, r["jac_scan"], 1e-9)
    close(J_ref, r["jac"], 1e-9)
    np.testing.assert_allclose(n(J_scan), n(J_ref), rtol=1e-8, atol=1e-10)
    close(pt.final_state_jacobian(xt), r["final_jac"], 1e-9)
    tr = TerminalResiduals(pt, torch_terminal)
    close(tr(xt), r["tr"], 1e-10)
    close(tr.jacobian(xt), r["tr_jac"], 1e-9)
    from nimblephysics_tpu_torch.trajectory.problem import jacobian

    np.testing.assert_allclose(n(tr.jacobian(xt)), n(jacobian(tr, xt)), rtol=1e-8, atol=1e-10)
    # The pinned step's force columns are zero.
    c = (pt.num_shots - 1) * 2 * pt.nv + PIN_T * pt.na
    assert float(J_scan[:, c].abs().max()) == 0.0


def test_single_shot_final_state_jacobian(cart):
    """backpropJacobianOfFinalState by rows against the final state's
    Ridders finite differences in the last force."""
    _, _, probs, _ = cart
    _, pt, x = probs["single"]
    J = pt.backprop_jacobian_of_final_state(t64(x))
    assert J.shape == (4, pt.num_variables) and torch.isfinite(J).all()

    def f(u):
        xs = x.copy()
        xs[-1:] = u
        with torch.no_grad():
            return n(pt.final_state(t64(xs)))

    fd = finite_difference_jacobian(f, x[-1:])
    np.testing.assert_allclose(n(J[:, -1:]), fd, rtol=0, atol=1e-7)
    assert np.abs(fd).max() > 1e-4


def _iterates(run):
    xs = []
    run(lambda *a: xs.append(np.array(n(a[-1]))))
    return xs


def test_sgd_first_iterates_match_jax(cart):
    jw, tw, probs, _ = cart
    pj, pt, x = probs["single"]
    jx = _iterates(lambda cb: JaxSGD(iterations=4, learning_rate=0.5).optimize(
        pj, jnp.asarray(x), callback=cb))
    tx = _iterates(lambda cb: SGDOptimizer(iterations=4, learning_rate=0.5).optimize(
        pt, t64(x), callback=cb))
    assert len(jx) == len(tx) == 4
    for a, b in zip(tx[1:], jx[1:]):  # x before steps 2, 3, 4: the first three iterates
        close(a, b, 1e-8)


def test_augmented_lagrangian_iterates_match_jax(cart):
    """Two outer iterations of three inner Adam steps: x after each inner
    loop (its third iterate) and after the multiplier and penalty update."""
    jw, tw, probs, _ = cart
    pj, pt, x = probs["multi"]
    kw = dict(outer_iterations=2, inner_iterations=3, learning_rate=0.3)
    jx = _iterates(lambda cb: JaxAL(**kw).optimize(pj, jnp.asarray(x), callback=cb))
    tx = _iterates(lambda cb: AugmentedLagrangianOptimizer(**kw).optimize(
        pt, t64(x), callback=cb))
    assert len(jx) == len(tx) == 2
    for a, b in zip(tx, jx):
        close(a, b, 1e-8)


def test_rollout_to_json(cart):
    _, _, probs, ref = cart
    _, pt, x = probs["mapped"]
    d = json.loads(pt.rollout(t64(x)).to_json())
    np.testing.assert_allclose(d["poses"], ref["mapped"]["poses"], rtol=1e-10, atol=1e-12)
    assert np.asarray(d["forces"]).shape == (10, 1)
    assert TrajectoryRollout._fields == ("poses", "vels", "forces", "mapped")


# ---------------------------------------------------------------------------
# The JAX tests' end criteria on the port's optimisers
# ---------------------------------------------------------------------------


def _cart_problem(cls, steps, dt=0.05, **kw):
    """The cartpole problem at a time step of `dt` (the JAX tests' 0.02
    with 24 to 40 steps; 0.05 gives their horizons in fewer steps)."""
    _, tw = cart_pair()
    tw.time_step = dt
    prob = cls(tw, torch_loss, steps, device="cpu", **kw)
    return prob, prob.initial_guess(START)


def test_sgd_reduces_loss():
    """tests/test_trajectory.py:43-50's criterion, loss below 5% of the
    start, on a 16-step SingleShot (0.8 s, the JAX test's horizon) with 30
    iterations at a learning rate of 4 (the JAX test: 120 at 0.5)."""
    prob, x0 = _cart_problem(SingleShot, 16)
    sol = SGDOptimizer(iterations=30, learning_rate=4.0).optimize(prob, x0)
    loss0 = float(prob.loss(x0))
    assert sol.loss < 0.05 * loss0, (sol.loss, loss0)
    assert sol.rollout.poses.shape == (16, 2)


def test_augmented_lagrangian_reaches_knot_feasibility():
    """A knot violation below 1e-4 (tests/test_trajectory.py:74-80 holds
    1e-2 with 6 x 80 iterations on 40 steps) on 6 steps in shots of 3,
    16 outer x 8 inner iterations."""
    prob, x0 = _cart_problem(MultiShot, 6, shot_length=3)
    calls = []
    sol = AugmentedLagrangianOptimizer(outer_iterations=16, inner_iterations=8,
                                       learning_rate=0.2).optimize(
        prob, x0, callback=lambda k, f, viol, x: calls.append(viol))
    assert sol.constraint_violation < 1e-4, (sol.constraint_violation, calls)
    assert len(calls) > 1 and calls[0] > 1e-2  # it started infeasible
    assert torch.isfinite(sol.rollout.poses).all() and sol.rollout.poses.shape == (6, 2)


def test_host_interior_point_solves():
    """tests/test_trajectory.py:82-101's criteria (a knot violation below
    1e-4, a fifth of the start loss, more than 5 callbacks) on 10 steps in
    shots of 5: SLSQP, as no cyipopt is installed."""
    prob, x0 = _cart_problem(MultiShot, 10, shot_length=5)
    calls = []
    sol = HostInteriorPointOptimizer(max_iterations=60).optimize(
        prob, x0, callback=lambda k, f, viol, x: calls.append((f, viol)))
    assert len(calls) > 5
    assert sol.constraint_violation < 1e-4, sol.constraint_violation
    assert sol.loss < 0.2 * float(prob.loss(x0)), (sol.loss, float(prob.loss(x0)))
    assert torch.isfinite(sol.rollout.poses).all()


def test_gauss_newton_reduces_loss_at_feasibility():
    """tests/test_atlas_trajectory.py:118's criteria (loss below a tenth of
    the start, knot violation at most 1e-4) on 12 steps in shots of 4,
    5 outer x 4 inner iterations, with the per-step Jacobians."""
    prob, x0 = _cart_problem(MultiShot, 12, shot_length=4)

    def fn(final, forces):
        return torch.cat([np.sqrt(W_POS) * (final[0:1] - TARGET),
                          np.sqrt(W_VEL) * final[2:3], np.sqrt(W_EFF) * forces.reshape(-1)])

    res = TerminalResiduals(prob, fn)
    sol = GaussNewtonOptimizer(outer_iterations=5, inner_iterations=4, rho0=10.0).optimize(
        prob, res, x0=x0, structured_jacobian=True)
    loss0 = float(prob.loss(x0))
    assert sol.loss < 0.1 * loss0, (sol.loss, loss0)
    assert sol.constraint_violation <= 1e-4, sol.constraint_violation


# ---------------------------------------------------------------------------
# Half-cheetah in shallow contact
# ---------------------------------------------------------------------------


def jax_cheetah_loss(ro):
    return jnp.sum(ro.vels[-1] ** 2) + 1e-3 * jnp.sum(ro.forces ** 2)


def torch_cheetah_loss(ro):
    return torch.sum(ro.vels[-1] ** 2) + 1e-3 * torch.sum(ro.forces ** 2)


@pytest.fixture(scope="module")
def cheetah():
    """MultiShot 2 x 2 from torch_parity's shallow-contact rollout after 90
    steps (four live rows a step). From its state 91 the second cold step
    falls to the LCP's ladder (impulses on separating normals), where the
    port's and the JAX package's single-world engines part by 2.0e-4 and
    the JAX package's own batched and single-world engines by 3.4e-5."""
    jw, tw, q, v, u = shallow_cheetah_state(steps=90)
    start = np.concatenate([q, v])
    pj = JaxMultiShot(jw, jax_cheetah_loss, 4, 2, start_state=jnp.asarray(start))
    pt = MultiShot(tw, torch_cheetah_loss, 4, 2, start_state=start, device="cpu")
    rng = np.random.RandomState(4)
    act = np.asarray(u)[np.asarray(tw.action_indices)]
    forces = act[None] + 0.5 * rng.randn(4, tw.action_size)
    knot = start + np.r_[1e-4 * rng.randn(tw.num_dofs), 1e-2 * rng.randn(tw.num_dofs)]
    x = np.concatenate([knot, forces.reshape(-1)])
    f = jax.jit(lambda x: (pj.rollout(x).poses, pj.rollout(x).vels, pj.constraints(x),
                           pj.loss(x)))
    ref = [np.asarray(a) for a in f(jnp.asarray(x))]
    return pt, x, ref


def test_cheetah_multishot_forward_matches_jax(cheetah):
    pt, x, (poses, vels, cons, loss) = cheetah
    with torch.no_grad():
        ro = pt.rollout(t64(x))
        close(ro.poses, poses, 1e-9)
        close(ro.vels, vels, 1e-9)
        close(pt.constraints(t64(x)), cons, 1e-9)
        close(pt.loss(t64(x)), loss, 1e-9)
    # Contact rows are live on this path: the cold-started first step has
    # impulses.
    from nimblephysics_tpu_torch.neural import Engine

    nv = pt.nv
    s = t64(x[: 2 * nv])
    r = Engine(pt.world, device="cpu").step(s[:nv], s[nv:], pt.world.action_to_forces(
        t64(x[2 * nv : 2 * nv + pt.na])))
    assert float(r.impulses.abs().max()) > 0


def test_cheetah_constraint_jacobian_scan_vs_reverse_pass_and_fd(cheetah):
    pt, x, _ = cheetah
    xt = t64(x)
    J_scan = pt.constraint_jacobian_scan(xt)
    J_rev = pt.constraint_jacobian(xt)
    np.testing.assert_allclose(n(J_scan), n(J_rev), rtol=0,
                               atol=1e-8 * (1.0 + float(J_rev.abs().max())))
    # One column block: the first force row of shot 0, by the port's Ridders
    # finite differences of h.
    c0 = 2 * pt.nv
    cols = slice(c0, c0 + pt.na)

    def h(xs):
        full = x.copy()
        full[cols] = xs
        with torch.no_grad():
            return n(pt.constraints(t64(full)))

    fd = finite_difference_jacobian(h, x[cols])
    np.testing.assert_allclose(n(J_scan[:, cols]), fd, rtol=0,
                               atol=2e-6 * (1.0 + np.abs(fd).max()))
    assert np.abs(fd).max() > 1e-3

"""nimblephysics_tpu_torch's BatchedEnv (simulation/env.py), Recording and
checkpoints (simulation/recording.py) and SimpleFeatherstone
(dynamics/simple_featherstone.py) against the JAX package, float64 on the
CPU.

* BatchedEnv on the cartpole at 16 worlds (tests/test_env.py's world and
  reward) and the half-cheetah at 4 worlds in contact, 3 to 4 steps:
  states, rewards, dones and step counts against the JAX BatchedEnv at
  1e-9 (the port's BatchedEngine against the JAX single-world engine
  vmapped). Both take the same start states, actions and a deterministic
  reset sampler (the JAX key splits have no torch counterpart); the
  auto-reset at the horizon; the gradient through a 3-step env rollout
  against the port's Ridders finite differences.
* aba_forward_dynamics against JAX and world_forward_dynamics at 1e-10
  of 1 + max|ddq|;
  Recording save/load and a checkpoint round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import cartpole as jax_cartpole
from nimblephysics_tpu.simulation import BatchedEnv as JaxEnv
from nimblephysics_tpu.simulation import EnvState as JaxEnvState

from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.math import finite_difference_jacobian
from nimblephysics_tpu_torch.simulation import BatchedEnv, EnvState
from torch_parity import F64, dump_world, n, shallow_cheetah_states, t64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: a single-world step is
    thousands of tiny ops, which more threads a process only slow when
    test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_pole_reward(s, a, s2):
    return 1.0 - jnp.abs(s2[1])  # keep the pole upright


def torch_pole_reward(s, a, s2):
    return 1.0 - torch.abs(s2[1])


def jax_run_reward(s, a, s2):
    return s2[9] - 1e-3 * jnp.sum(a ** 2)  # forward speed, effort


def torch_run_reward(s, a, s2):
    return s2[9] - 1e-3 * torch.sum(a ** 2)


def envs(jw, jreward, treward, reset, horizon, B):
    tw = world_from_arrays(dump_world(jw))
    je = JaxEnv(jw, jreward, reset_sampler=lambda key: jnp.asarray(reset),
                horizon=horizon, batch_size=B)
    te = BatchedEnv(tw, treward, reset_sampler=lambda g, k: t64(reset).expand(k, -1),
                    horizon=horizon, batch_size=B, device="cpu", dtype=torch.float64)
    return je, te


def run_both(je, te, states, steps, actions):
    """Step both envs from the same EnvState through `actions` (T, B, na):
    per step (port output, JAX output as numpy)."""
    js = JaxEnvState(jnp.asarray(states), jnp.asarray(steps, jnp.int32), jax.random.PRNGKey(0))
    ts = EnvState(t64(states), torch.as_tensor(steps, dtype=torch.int32),
                  torch.Generator().manual_seed(0))
    out = []
    with torch.no_grad():
        for a in actions:
            jo = je.step(js, jnp.asarray(a))
            te_o = te.step(ts, t64(a))
            js, ts = jo.env_state, te_o.env_state
            out.append((te_o, jax.tree_util.tree_map(np.asarray, jo)))
    return out


def hold(out):
    for to, jo in out:
        np.testing.assert_allclose(n(to.obs), jo.obs, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(n(to.reward), jo.reward, rtol=1e-9, atol=1e-9)
        np.testing.assert_array_equal(n(to.done), jo.done)
        np.testing.assert_array_equal(n(to.env_state.steps), jo.env_state.steps)
        assert to.env_state.steps.dtype == torch.int32 and to.obs.shape == jo.obs.shape


def test_cartpole_env_matches_jax_with_auto_reset():
    jw, _, _ = jax_cartpole()
    jw.set_action_space([0])
    B, H = 16, 3
    reset = np.array([0.01, -0.02, 0.0, 0.03])
    je, te = envs(jw, jax_pole_reward, torch_pole_reward, reset, H, B)
    rng = np.random.RandomState(0)
    states = np.c_[0.1 * rng.randn(B, 2), 0.3 * rng.randn(B, 2)]
    steps = rng.randint(0, H, B)
    actions = 3.0 * rng.randn(4, B, 1)
    out = run_both(je, te, states, steps, actions)
    hold(out)
    # Each world is done at the step that brings it to the horizon and
    # starts again from the reset state with its count at 0.
    for k, (to, _) in enumerate(out):
        want = (steps + k + 1) % H == 0
        np.testing.assert_array_equal(n(to.done), want)
        np.testing.assert_array_equal(n(to.obs)[want], np.tile(reset, (want.sum(), 1)))
        assert bool((to.env_state.steps[torch.as_tensor(want)] == 0).all())
    assert te.observation_size == 4 and te.action_size == 1


def test_half_cheetah_env_matches_jax():
    """Four worlds in shallow contact (states 87-90 of torch_parity's
    shallow-contact rollout), three steps under controls near the
    rollout's. Its state 91 is left out: stepped cold from there under
    these controls, the JAX package's own batched and single-world engines
    part by 3.4e-5 after two steps (the port's BatchedEngine follows the
    JAX BatchedEngine there to 1.5e-11)."""
    jw, tw, qs, vs, us = shallow_cheetah_states(keep=5)
    qs, vs, us = qs[:4], vs[:4], us[:4]
    B, nv = 4, jw.num_dofs
    rng = np.random.RandomState(3)
    states = np.c_[qs, vs]
    reset = np.r_[qs[0], vs[0]]
    je, te = envs(jw, jax_run_reward, torch_run_reward, reset, 1000, B)
    idx = np.asarray(jw.action_indices)
    actions = us[None, :, idx] + 0.3 * rng.randn(3, B, jw.action_size)
    out = run_both(je, te, states, np.zeros(B, int), actions)
    hold(out)
    assert not any(bool(to.done.any()) for to, _ in out)
    # The contact rows are live on this path.
    eng = te.engine
    s = t64(states).T
    res = eng.step(s[:nv], s[nv:], eng.action_to_forces(t64(actions[0]).T))
    assert float(res.impulses.abs().max()) > 0


def test_gradient_through_env_rollout_matches_finite_differences():
    """tests/test_env.py's policy gradient: d(return)/d(linear policy) over
    3 steps at 4 worlds, horizon 2 (one auto-reset inside), against the
    port's Ridders finite differences; the return rewards the cart's speed
    and the pole upright."""
    jw, _, _ = jax_cartpole()
    jw.set_action_space([0])
    tw = world_from_arrays(dump_world(jw))
    reset = np.array([0.0, 0.2, 0.0, 0.0])
    env = BatchedEnv(tw, lambda s, a, s2: s2[2] - torch.abs(s2[1]),
                     reset_sampler=lambda g, k: t64(reset).expand(k, -1),
                     horizon=2, batch_size=4, device="cpu", dtype=torch.float64)
    rng = np.random.RandomState(5)
    start = np.c_[0.1 * rng.randn(4, 2), 0.2 * rng.randn(4, 2)]

    def ret(w):
        st = EnvState(t64(start), torch.zeros(4, dtype=torch.int32), torch.Generator())
        total = 0.0
        for _ in range(3):
            out = env.step(st, 20.0 * torch.tanh(st.state @ w))
            st, total = out.env_state, total + out.reward.sum()
        return total

    w0 = t64(0.3 * rng.randn(4, 1)).requires_grad_()
    (g,) = torch.autograd.grad(ret(w0), [w0])

    def f(w):
        with torch.no_grad():
            return n(ret(t64(w))).reshape(1)

    fd = finite_difference_jacobian(f, n(w0))[0].reshape(4, 1)
    np.testing.assert_allclose(n(g), fd, rtol=0, atol=2e-6 * (1 + np.abs(fd).max()))
    assert np.abs(fd).max() > 1e-3


def test_env_reset_draws_from_the_generator():
    tw = world_from_arrays(dump_world(jax_cartpole()[0]))
    env = BatchedEnv(tw, torch_pole_reward, horizon=5, batch_size=8, device="cpu")
    a, b = env.reset(0), env.reset(0)
    assert a.state.shape == (8, 4) and a.state.dtype == torch.float32
    torch.testing.assert_close(a.state, b.state, rtol=0, atol=0)
    assert a.steps.dtype == torch.int32 and int(a.steps.abs().sum()) == 0
    assert not torch.equal(env.reset(1).state, a.state)
    out = env.step(a, torch.zeros(8, env.action_size))
    assert out.obs.shape == (8, 4) and out.reward.shape == (8,)


# ---------------------------------------------------------------------------
# SimpleFeatherstone, Recording, checkpoints
# ---------------------------------------------------------------------------


def chain():
    """tests/test_extras.py's six-joint chain (one prismatic)."""
    from nimblephysics_tpu.dynamics import PRISMATIC, REVOLUTE, Skeleton

    rng = np.random.RandomState(0)
    T = np.eye(4)
    T[2, 3] = -0.3
    sk = Skeleton("chain")
    p = -1
    for i in range(6):
        jt = PRISMATIC if i == 3 else REVOLUTE
        ax = rng.randn(3)
        ax /= np.linalg.norm(ax)
        p = sk.add_joint_and_body(
            jt, parent=p, axis=ax, T_pj=T if i else np.eye(4),
            T_cj=np.eye(4) if i % 2 else T, mass=0.5 + i * 0.2,
            com=rng.randn(3) * 0.05, inertia=np.eye(3) * 0.02,
        )
    return sk, rng


def test_aba_matches_jax_and_world_forward_dynamics():
    from nimblephysics_tpu.dynamics import aba_forward_dynamics as jax_aba
    from nimblephysics_tpu.dynamics import flatten_chain as jax_flatten
    from nimblephysics_tpu.simulation import World as JaxWorld

    from nimblephysics_tpu_torch.dynamics import aba_forward_dynamics, flatten_chain
    from nimblephysics_tpu_torch.simulation import world_forward_dynamics

    sk, rng = chain()
    jw = JaxWorld(gravity=(0.0, 0.0, -9.81))
    jw.add_skeleton(sk)
    tw = world_from_arrays(dump_world(jw))
    g = np.array([0.0, 0.0, -9.81])
    jchain = jax_flatten(sk)
    aba = jax.jit(lambda *a: jax_aba(jchain, *a))
    for _ in range(3):
        q, dq, tau = rng.randn(6) * 0.4, rng.randn(6), rng.randn(6)
        want = np.asarray(aba(jnp.asarray(q), jnp.asarray(dq), jnp.asarray(tau),
                              jnp.asarray(g)))
        got = aba_forward_dynamics(flatten_chain(tw.skeletons[0]), t64(q), t64(dq), t64(tau),
                                   t64(g))
        tol = 1e-10 * (1.0 + np.abs(want).max())
        np.testing.assert_allclose(n(got), want, rtol=0, atol=tol)
        dense = world_forward_dynamics(tw, t64(q), t64(dq), t64(tau))
        np.testing.assert_allclose(n(got), n(dense), rtol=0, atol=tol)


def test_recording_save_load(tmp_path):
    from nimblephysics_tpu_torch.models import box_drop
    from nimblephysics_tpu_torch.simulation import Recording

    w, _, _ = box_drop()
    rec = Recording(w)
    for k in range(5):
        rec.bake(np.full(12, float(k)) if k % 2 else torch.full((12,), float(k), **F64))
    assert rec.num_frames == 5
    np.testing.assert_allclose(rec.get_state(3), 3.0)
    p = str(tmp_path / "rec.npy")
    rec.save(p)
    rec2 = Recording.load(w, p)
    np.testing.assert_allclose(rec2.as_array(), rec.as_array())
    rec.clear()
    assert rec.as_array().shape == (0, 12)


def test_checkpoint_round_trip(tmp_path):
    from nimblephysics_tpu_torch.simulation import load_checkpoint, save_checkpoint

    tree = {"params": {"w": torch.randn(3, 2, **F64), "b": np.arange(4.0)},
            "step": 7, "plans": [torch.ones(2, 5), torch.zeros(1)]}
    p = str(tmp_path / "ckpt.pt")
    save_checkpoint(p, tree)
    flat = torch.load(p, weights_only=True)  # a dict of tensors by path
    assert len(flat) == 5 and all(torch.is_tensor(x) for x in flat.values())
    back = load_checkpoint(p, tree)
    torch.testing.assert_close(back["params"]["w"], tree["params"]["w"], rtol=0, atol=0)
    assert isinstance(back["params"]["b"], np.ndarray)
    np.testing.assert_array_equal(back["params"]["b"], tree["params"]["b"])
    assert back["step"] == 7 and len(back["plans"]) == 2
    with pytest.raises(KeyError):
        load_checkpoint(p, {"other": torch.zeros(1)})

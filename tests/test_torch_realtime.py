"""nimblephysics_tpu_torch's realtime layer (realtime/buffers.py, mpc.py,
ssid.py, mpc_grpc.py) against the JAX package, float64 on the CPU, on the
cartpole with the action on the cart.

* One optimize_plan of MPCLocal (horizon 5, 3 Adam iterations), and a
  second one after two control steps (its warm start shifted by two
  rows), plan against the JAX MPCLocal at 1e-8; the shift itself; the
  background thread replans; the TCP/JSON round trip.
* SSID's fitted masses after 5 iterations against the JAX SSID at 1e-8,
  and the recovery of a heavier cart (tests/test_realtime.py:93's
  criterion, rtol 0.08, on a shorter fit).
* Buffer indexing and the Ticker; the gRPC wire bytes and round trip where
  grpc and protobuf are installed.

Thread and server tests poll with their own deadlines and take free ports.
The JAX side of each comparison is one jax.jit.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import cartpole as jax_cartpole
from nimblephysics_tpu.realtime import MPCLocal as JaxMPCLocal
from nimblephysics_tpu.realtime import SSID as JaxSSID

from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.neural import get_engine
from nimblephysics_tpu_torch.realtime import MPCLocal, MPCRemote, SSID, Ticker
from nimblephysics_tpu_torch.realtime.buffers import RealTimeControlBuffer
from torch_parity import dump_world, t64

TARGET = 0.4
HEAVY_CART = np.array([12.0, 4.8953899])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: a single-world step is
    thousands of tiny ops, which more threads a process only slow when
    test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pair():
    jw, _, _ = jax_cartpole()
    jw.set_action_space([0])
    return jw, world_from_arrays(dump_world(jw))


def jax_mpc_loss(poses, vels, forces):
    return (10.0 * jnp.sum((poses[-1, 0] - TARGET) ** 2) + 0.1 * jnp.sum(vels[-1] ** 2)
            + 1e-5 * jnp.sum(forces ** 2))


def torch_mpc_loss(poses, vels, forces):
    return (10.0 * torch.sum((poses[-1, 0] - TARGET) ** 2) + 0.1 * torch.sum(vels[-1] ** 2)
            + 1e-5 * torch.sum(forces ** 2))


def wait_for(cond, timeout):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def plans(mpc, states, dt):
    """optimize_plan at t = 0 from states[0], then at t = 2 dt from
    states[1]: the two plans."""
    out = []
    for t, s in zip((0.0, 2 * dt), states):
        mpc.record_ground_truth_state(t, s)
        mpc.optimize_plan(t)
        out.append(mpc.buffer.get_plan_copy()[1])
    return out


def test_optimize_plan_matches_jax():
    jw, tw = pair()
    rng = np.random.RandomState(1)
    states = [np.r_[0.05 * rng.randn(2), 0.1 * rng.randn(2)] for _ in range(2)]
    kw = dict(horizon_steps=5, replan_iterations=3, learning_rate=0.3)
    jp = plans(JaxMPCLocal(jw, jax_mpc_loss, **kw), states, jw.time_step)
    tp = plans(MPCLocal(tw, torch_mpc_loss, device="cpu", **kw), states, tw.time_step)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * (1 + np.abs(b).max()))
    assert np.abs(tp[0]).max() > 0


def test_warm_start_shift():
    """A replan at t starts from the previous plan shifted by the steps
    elapsed since it began, its last row repeated (MPCLocal.cpp:179)."""
    _, tw = pair()
    mpc = MPCLocal(tw, torch_mpc_loss, horizon_steps=5, replan_iterations=1, device="cpu")
    mpc.record_ground_truth_state(0.0, np.zeros(4))
    mpc.optimize_plan(0.0)
    first = mpc._plan.clone()
    seen = []
    replan = mpc.replan
    mpc.replan = lambda forces, start: seen.append(forces.clone()) or replan(forces, start)
    mpc.record_ground_truth_state(2 * tw.time_step, np.zeros(4))
    mpc.optimize_plan(2 * tw.time_step)
    want = torch.cat([first[2:], first[-1:].expand(2, -1)])
    torch.testing.assert_close(seen[0], want, rtol=0, atol=0)
    assert mpc.buffer.get_plan_copy()[0] == 2 * tw.time_step


def test_background_thread_replans():
    _, tw = pair()
    mpc = MPCLocal(tw, torch_mpc_loss, horizon_steps=5, replan_iterations=2, device="cpu")
    mpc.record_ground_truth_state(0.0, np.zeros(4))
    mpc.optimize_plan(0.0)
    count0 = mpc._replan_count
    mpc.start()
    try:
        assert wait_for(lambda: mpc._replan_count > count0, timeout=60.0)
    finally:
        mpc.stop()
    assert not mpc._running and mpc._thread is None
    # Stopped means stopped: no replan after stop() returns.
    count1 = mpc._replan_count
    time.sleep(0.05)
    assert mpc._replan_count == count1


def test_remote_roundtrip():
    _, tw = pair()
    mpc = MPCLocal(tw, torch_mpc_loss, horizon_steps=5, replan_iterations=2, device="cpu")
    mpc.record_ground_truth_state(0.0, np.zeros(4))
    mpc.optimize_plan(0.0)
    th = mpc.serve(0)
    try:
        remote = MPCRemote("127.0.0.1", th.port)
        f = remote.get_force(0.0)
        np.testing.assert_allclose(f, mpc.get_force(0.0), rtol=0, atol=1e-12)
        remote.record_ground_truth_state(0.01, np.zeros(4))
        assert len(mpc.observation_log) == 2
        remote.close()
    finally:
        th.server.shutdown()
        th.server.server_close()


def ssid_window(world, window, seed=0):
    """The JAX test's data: a heavier cart driven by 4 N(0, 1) forces from
    [0, 0.2, 0, 0], stepped by the port's engine; (states, controls)."""
    eng = get_engine(world, device="cpu")
    rng = np.random.RandomState(seed)
    s = t64([0.0, 0.2, 0.0, 0.0])
    states, controls = [s.numpy().copy()], []
    with torch.no_grad():
        for _ in range(window):
            u = t64(rng.randn(1) * 4.0)
            s = eng.state_step(s, u, t64(HEAVY_CART))
            controls.append(u.numpy().copy())
            states.append(s.numpy().copy())
    return states, controls


def fit(ssid, states, controls, dt):
    t = 0.0
    ssid.register_sensors(t, states[0])
    for s, u in zip(states[1:], controls):
        ssid.register_controls(t, u)
        t += dt
        ssid.register_sensors(t, s)
    return ssid.run_inference()


def test_ssid_matches_jax():
    jw, tw = pair()
    states, controls = ssid_window(tw, 5)
    kw = dict(window_steps=5, fit_iterations=5, learning_rate=0.08)
    losses = []
    tssid = SSID(tw, device="cpu", **kw)
    tssid.register_inferred_mass_listener(lambda m, loss: losses.append(loss))
    jm = fit(JaxSSID(jw, **kw), states, controls, jw.time_step)
    tm = fit(tssid, states, controls, tw.time_step)
    np.testing.assert_allclose(tm, jm, rtol=1e-8, atol=0)
    assert np.abs(tm - np.array([9.42477796, 4.8953899])).max() > 1e-2  # it moved
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_ssid_recovers_cart_mass():
    """tests/test_realtime.py:93's criterion (the cart's 12 kg within 8%)
    on a 10-step window and 40 iterations (the JAX test: 15 and 150)."""
    _, tw = pair()
    states, controls = ssid_window(tw, 10)
    ssid = SSID(tw, window_steps=10, fit_iterations=40, learning_rate=0.08, device="cpu")
    fitted = fit(ssid, states, controls, tw.time_step)
    np.testing.assert_allclose(fitted[0], 12.0, rtol=0.08)


def test_ticker_fires():
    ticks = []
    tk = Ticker(0.02)
    tk.register_tick_listener(lambda t: ticks.append(t))
    tk.start()
    try:
        assert wait_for(lambda: len(ticks) >= 5, timeout=10.0)
    finally:
        tk.stop()
    assert all(b >= a for a, b in zip(ticks, ticks[1:]))


def test_buffer_indexing():
    buf = RealTimeControlBuffer(2, 4, 0.1)
    plan = np.arange(8).reshape(4, 2).astype(float)
    buf.set_control_force_plan(1.0, plan)
    np.testing.assert_allclose(buf.control_at(1.05), [0, 1])
    np.testing.assert_allclose(buf.control_at(1.25), [4, 5])
    np.testing.assert_allclose(buf.control_at(99.0), [6, 7])  # clamp
    # The state projection steps the engine through the plan.
    _, tw = pair()
    eng = get_engine(tw, device="cpu")
    b2 = RealTimeControlBuffer(1, 3, tw.time_step)
    b2.set_control_force_plan(0.0, np.array([[1.0], [2.0], [3.0]]))
    got = b2.estimate_world_state_at(eng, 0.0, np.zeros(4), 2 * tw.time_step)
    with torch.no_grad():
        s = eng.state_step(t64(np.zeros(4)), t64([1.0]))
        s = eng.state_step(s, t64([2.0]))
    np.testing.assert_allclose(got, s.numpy(), rtol=0, atol=0)


def test_listen_reply_bytes_pinned():
    """tests/test_realtime.py's golden MPCListenForUpdatesReply: the port's
    schemas serialize the same message to the same bytes and decode them
    back."""
    pytest.importorskip("google.protobuf")
    from nimblephysics_tpu_torch.realtime.mpc_grpc import _mat, _mat_to_np, load_messages

    golden_path = os.path.join(os.path.dirname(__file__), "data",
                               "mpc_listen_reply.golden.bin")
    with open(golden_path, "rb") as f:
        golden = f.read()
    M = load_messages()
    plan = np.array([[0.5, -1.25, 2.0], [0.125, 0.0, -3.5]])
    reply = M["MPCListenForUpdatesReply"]()
    reply.startTime = 1234
    reply.rollout.representationMapping = "identity"
    reply.rollout.force["identity"].CopyFrom(_mat(M, plan))
    assert reply.SerializeToString() == golden
    decoded = M["MPCListenForUpdatesReply"].FromString(golden)
    assert decoded.startTime == 1234
    np.testing.assert_array_equal(_mat_to_np(decoded.rollout.force["identity"]), plan)


def test_grpc_service_roundtrip():
    pytest.importorskip("grpc")
    from nimblephysics_tpu_torch.realtime.mpc_grpc import MPCRemoteGrpc, serve_mpc_grpc

    _, tw = pair()
    mpc = MPCLocal(tw, torch_mpc_loss, horizon_steps=5, replan_iterations=2, device="cpu")
    mpc.record_ground_truth_state(0.0, np.zeros(4))
    mpc.optimize_plan(0.0)
    server = serve_mpc_grpc(mpc, 0, update_hz=50.0)
    try:
        remote = MPCRemoteGrpc("127.0.0.1", server.bound_port, dt=tw.time_step)
        remote.start()
        try:
            assert remote.wait_for_plan(timeout=30.0)
            # The replan thread runs on: poll until the remote holds the
            # plan the buffer holds (the stream carries each one at 50 Hz).
            assert wait_for(lambda: np.allclose(remote.get_force(0.0), mpc.get_force(0.0),
                                                rtol=0, atol=1e-12), timeout=30.0)
            n_obs0 = len(mpc.observation_log)
            remote.record_ground_truth_state(0.01, np.zeros(4))
            assert wait_for(lambda: len(mpc.observation_log) > n_obs0, timeout=10.0)
        finally:
            remote.stop()
    finally:
        server.stop(grace=None)
    # The Stop RPC stopped the background optimizer.
    assert not mpc._running

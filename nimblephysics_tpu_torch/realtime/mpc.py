"""Receding-horizon MPC with a background replanning thread.

Counterpart of nimblephysics_tpu/realtime/mpc.py. Reference parity:
dart/realtime/MPCLocal (optimizationThreadLoop MPCLocal.cpp:494-504,
optimizePlan:179-260 — warm-started re-optimization on a background
thread, plans written into a RealTimeControlBuffer) and the MPC interface
(MPC.hpp:13). The remoting surface (MPCRemote) runs over a plain TCP/JSON
transport; realtime/mpc_grpc.py serves the reference's gRPC contract.

A replan is `replan_iterations` Adam steps on the horizon loss, each one
reverse pass through a rollout of the single-world Engine, on the
engine's device (the card unless the caller passes device="cpu").

Threads: the replan thread (`start`) and the caller's thread share the
Engine that `get_engine` caches on the world. The engine keeps no state
between calls, and torch may launch work on one device from two threads,
so a caller may step that engine while a replan runs. What `MPCLocal.lock`
guards is a replan itself: `optimize_plan` holds it for the whole cycle
(estimate, replan, plan and buffer update), so the background thread and a
caller's own `optimize_plan` never replan at once and never interleave
their plan updates.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from nimblephysics_tpu_torch.neural.timestep import get_engine
from nimblephysics_tpu_torch.realtime.buffers import (
    ObservationLog,
    RealTimeControlBuffer,
)
from nimblephysics_tpu_torch.simulation.world import World
from nimblephysics_tpu_torch.trajectory.optimizers import value_and_grad


def adam(f: Callable, x: torch.Tensor, iterations: int, learning_rate: float, *args):
    """`iterations` Adam steps on f(x, *args) from x, with the JAX
    package's constants (0.9, 0.999, 1e-8; bias correction at step t + 1).
    Returns (x, the loss at the last step's start)."""
    m, vv = torch.zeros_like(x), torch.zeros_like(x)
    loss = None
    for t in range(iterations):
        loss, g = value_and_grad(f, x, *args)
        m = 0.9 * m + 0.1 * g
        vv = 0.999 * vv + 0.001 * g * g
        mh = m / (1 - 0.9 ** (t + 1.0))
        vh = vv / (1 - 0.999 ** (t + 1.0))
        x = x - learning_rate * mh / (torch.sqrt(vh) + 1e-8)
    return x, loss


class MPC:
    """Abstract MPC interface (reference: MPC.hpp:13)."""

    def get_force(self, t: float) -> np.ndarray:
        raise NotImplementedError

    def record_ground_truth_state(self, t: float, state: np.ndarray) -> None:
        raise NotImplementedError


class MPCLocal(MPC):
    def __init__(
        self,
        world: World,
        loss_fn: Callable,  # (poses (T,nq), vels, forces) -> scalar
        horizon_steps: int = 20,
        replan_iterations: int = 30,
        learning_rate: float = 0.1,
        device=None,
        dtype: torch.dtype = torch.float64,
    ):
        self.world = world
        self.engine = get_engine(world, device, dtype)
        self.horizon = horizon_steps
        self.dt = world.time_step
        self.na = world.action_size
        self.nv = world.num_dofs
        self.buffer = RealTimeControlBuffer(self.na, horizon_steps, self.dt)
        self.observation_log = ObservationLog(2 * self.nv)
        self.lock = threading.Lock()
        self._loss_fn = loss_fn
        self._iters = replan_iterations
        self._lr = learning_rate
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._plan = self._tensor(np.zeros((horizon_steps, self.na)))
        self._replan_count = 0

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.engine.dtype,
                               device=self.engine.device)

    def horizon_loss(self, forces: torch.Tensor, start_state: torch.Tensor) -> torch.Tensor:
        """The loss of the rollout of `forces` (H, na) from start_state."""
        s, states = start_state, []
        for u in forces:
            s = self.engine.state_step(s, u)
            states.append(s)
        states = torch.stack(states)
        return self._loss_fn(states[:, : self.nv], states[:, self.nv :], forces)

    def replan(self, forces: torch.Tensor, start_state: torch.Tensor) -> torch.Tensor:
        """Warm-started Adam re-optimization of a (H, na) plan."""
        return adam(self.horizon_loss, forces, self._iters, self._lr, start_state)[0]

    # -- MPC interface -------------------------------------------------------

    def get_force(self, t: float) -> np.ndarray:
        return self.buffer.control_at(t)

    def record_ground_truth_state(self, t: float, state: np.ndarray) -> None:
        self.observation_log.record(t, state)

    def optimize_plan(self, now: float) -> None:
        """One replan cycle (reference: MPCLocal::optimizePlan:179), under
        `lock`."""
        with self.lock:
            obs_t, obs = self.observation_log.latest()
            if obs is None:
                return
            start = self.buffer.estimate_world_state_at(self.engine, obs_t, obs, now)
            # Warm start: shift the previous plan by the elapsed steps.
            shift = max(0, int(round((now - self.buffer.get_plan_copy()[0]) / self.dt)))
            plan = self._plan.cpu().numpy()
            if 0 < shift < self.horizon:
                plan = np.concatenate([plan[shift:], np.tile(plan[-1:], (shift, 1))])
            new_plan = self.replan(self._tensor(plan), self._tensor(start))
            self._plan = new_plan
            self.buffer.set_control_force_plan(now, new_plan.cpu().numpy())
            self._replan_count += 1

    # -- background thread (reference: optimizationThreadLoop:494) -----------

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        t0 = time.monotonic()

        def loop():
            while self._running:
                self.optimize_plan(time.monotonic() - t0)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the replan thread; waits for its current replan to end."""
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- remoting (reference: gRPC service, MPCLocal.hpp:195-222) ------------

    def serve(self, port: int) -> "threading.Thread":
        """Serve this MPC over a TCP/JSON protocol for MPCRemote clients on
        127.0.0.1:port (port 0 takes a free one). The returned thread
        carries `server` (its `shutdown()` ends it) and `port`."""
        import json
        import socketserver

        mpc = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    msg = json.loads(line)
                    if msg["op"] == "get_force":
                        out = mpc.get_force(msg["t"]).tolist()
                    elif msg["op"] == "observe":
                        mpc.record_ground_truth_state(msg["t"], np.asarray(msg["state"]))
                        out = True
                    else:
                        out = None
                    self.wfile.write((json.dumps({"result": out}) + "\n").encode())
                    self.wfile.flush()

        server = socketserver.ThreadingTCPServer(("127.0.0.1", port), Handler)
        server.daemon_threads = True
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        th.server = server  # type: ignore
        th.port = server.server_address[1]  # type: ignore
        return th


class MPCRemote(MPC):
    """Client proxy to a served MPCLocal (reference: MPCRemote.hpp:8-66)."""

    def __init__(self, host: str, port: int):
        import socket

        self._sock = socket.create_connection((host, port))
        self._file = self._sock.makefile("rw")

    def _call(self, op: str, **kw):
        import json

        self._file.write(json.dumps({"op": op, **kw}) + "\n")
        self._file.flush()
        return json.loads(self._file.readline())["result"]

    def get_force(self, t: float) -> np.ndarray:
        return np.asarray(self._call("get_force", t=t))

    def record_ground_truth_state(self, t: float, state: np.ndarray) -> None:
        self._call("observe", t=t, state=np.asarray(state).tolist())

    def close(self) -> None:
        self._file.close()
        self._sock.close()

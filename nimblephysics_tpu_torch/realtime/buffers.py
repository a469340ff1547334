"""Realtime buffers and timers.

Copy of nimblephysics_tpu/realtime/buffers.py (numpy and threading only),
with the state projection stepping a torch Engine.

Reference parity: dart/realtime/RealTimeControlBuffer.hpp (time-indexed
force-plan buffer + state estimation used by MPCLocal.cpp:199),
ObservationLog / ControlLog / VectorLog, and Ticker (Ticker.hpp:13-23 —
fixed-rate callback timer driving GUI/MPC loops).

Host-side utilities (plain numpy + threads): this is the runtime *around*
the compute path on the device, not the compute path itself.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


class VectorLog:
    """Append-only time-stamped vector log (reference: VectorLog.hpp)."""

    def __init__(self, dim: int):
        self.dim = dim
        self._times: List[float] = []
        self._values: List[np.ndarray] = []
        self._lock = threading.Lock()

    def record(self, t: float, value: np.ndarray) -> None:
        with self._lock:
            self._times.append(float(t))
            self._values.append(np.asarray(value, dtype=np.float64))

    def values_after(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            idx = [i for i, tt in enumerate(self._times) if tt >= t]
            if not idx:
                return np.zeros(0), np.zeros((0, self.dim))
            return (
                np.asarray([self._times[i] for i in idx]),
                np.stack([self._values[i] for i in idx]),
            )

    def __len__(self):
        return len(self._times)


class ObservationLog(VectorLog):
    """State observations over time (reference: ObservationLog.hpp)."""

    def latest(self) -> Tuple[float, Optional[np.ndarray]]:
        with self._lock:
            if not self._times:
                return 0.0, None
            return self._times[-1], self._values[-1]


class ControlLog(VectorLog):
    """Applied control forces over time (reference: ControlLog.hpp)."""


class RealTimeControlBuffer:
    """Time-indexed force plan with estimation-forward state projection.

    Reference parity: RealTimeControlBuffer.hpp — the MPC writes a force
    plan for [t, t + horizon); the robot reads the force at the current
    time; `estimate_world_state_at` projects the last observation forward
    through the plan using the engine (MPCLocal.cpp:199), a
    single-world Engine, on its device.
    """

    def __init__(self, action_dim: int, horizon_steps: int, dt: float):
        self.action_dim = action_dim
        self.horizon = horizon_steps
        self.dt = dt
        self._plan_start: float = 0.0
        self._plan = np.zeros((horizon_steps, action_dim))
        self._lock = threading.Lock()

    def set_control_force_plan(
        self, start_time: float, plan: np.ndarray
    ) -> None:
        with self._lock:
            self._plan_start = float(start_time)
            self._plan = np.asarray(plan, dtype=np.float64).reshape(
                -1, self.action_dim
            )

    def get_plan_copy(self) -> Tuple[float, np.ndarray]:
        with self._lock:
            return self._plan_start, self._plan.copy()

    def control_at(self, t: float) -> np.ndarray:
        with self._lock:
            i = int(np.floor((t - self._plan_start) / self.dt))
            i = np.clip(i, 0, len(self._plan) - 1)
            return self._plan[i].copy()

    def estimate_world_state_at(
        self, engine, obs_time: float, obs_state: np.ndarray, t: float
    ) -> np.ndarray:
        """Roll the observed state forward to time t through the buffered
        plan (reference: estimateWorldStateAt)."""
        import torch

        steps = max(0, int(round((t - obs_time) / self.dt)))
        t_ = dict(dtype=engine.dtype, device=engine.device)
        s = torch.as_tensor(np.asarray(obs_state), **t_)
        with torch.no_grad():
            for k in range(steps):
                u = self.control_at(obs_time + k * self.dt)
                s = engine.state_step(s, torch.as_tensor(u, **t_))
        return s.cpu().numpy()


class Ticker:
    """Fixed-rate callback timer (reference: Ticker.hpp:13-23)."""

    def __init__(self, dt: float):
        self.dt = dt
        self._callbacks: List[Callable[[float], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def register_tick_listener(self, cb: Callable[[float], None]) -> None:
        self._callbacks.append(cb)

    def start(self) -> None:
        if self._running:
            return
        self._running = True

        def loop():
            t0 = time.monotonic()
            k = 0
            while self._running:
                now = time.monotonic()
                for cb in self._callbacks:
                    cb(now - t0)
                k += 1
                target = t0 + k * self.dt
                delay = target - time.monotonic()
                if delay > 0:
                    time.sleep(delay)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

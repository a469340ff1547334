"""SSID: online system identification over a sliding window.

Counterpart of nimblephysics_tpu/realtime/ssid.py. Reference parity:
dart/realtime/SSID (SSID.hpp:30-106 — logs sensors/controls, background
thread fitting masses/params to the observed window using trajectory
problems, SSID.cpp:110-140).

The window fit is `fit_iterations` Adam steps on the log-masses,
minimizing the simulation-vs-observation error through the single-world
Engine's `state_step(s, u, masses)` and its mass gradients, on the
engine's device (the card unless the caller passes device="cpu").
`SSID.lock` guards a fit: the background loop and a caller's
`run_inference` never fit at once.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from nimblephysics_tpu_torch.neural.timestep import get_engine
from nimblephysics_tpu_torch.realtime.buffers import ControlLog, ObservationLog
from nimblephysics_tpu_torch.realtime.mpc import adam
from nimblephysics_tpu_torch.simulation.world import World


class SSID:
    def __init__(
        self,
        world: World,
        window_steps: int = 20,
        fit_iterations: int = 50,
        learning_rate: float = 0.05,
        device=None,
        dtype: torch.dtype = torch.float64,
    ):
        self.world = world
        self.engine = get_engine(world, device, dtype)
        self.window = window_steps
        self.nv = world.num_dofs
        self.na = world.action_size
        self.dt = world.time_step
        self.observation_log = ObservationLog(2 * self.nv)
        self.control_log = ControlLog(self.na)
        self.masses = self._tensor(np.concatenate(
            [[b.mass for b in s.bodies] for s in world.skeletons]))
        self.lock = threading.Lock()
        self._iters = fit_iterations
        self._lr = learning_rate
        self._listeners: List[Callable] = []
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.engine.dtype,
                               device=self.engine.device)

    def window_loss(self, log_masses, start_state, controls, observed) -> torch.Tensor:
        """Mean squared error of the window's rollout under exp(log_masses)."""
        masses = torch.exp(log_masses)  # positivity
        s, states = start_state, []
        for u in controls:
            s = self.engine.state_step(s, u, masses)
            states.append(s)
        return torch.mean((torch.stack(states) - observed) ** 2)

    # -- logging (reference: registerSensorsNow/registerControlsNow) --------

    def register_sensors(self, t: float, state: np.ndarray) -> None:
        self.observation_log.record(t, state)

    def register_controls(self, t: float, action: np.ndarray) -> None:
        self.control_log.record(t, action)

    def register_inferred_mass_listener(self, cb: Callable) -> None:
        self._listeners.append(cb)

    # -- fitting --------------------------------------------------------------

    def run_inference(self) -> Optional[np.ndarray]:
        """Fit masses to the most recent window; returns updated masses."""
        if len(self.observation_log) < self.window + 1:
            return None
        with self.observation_log._lock:
            obs = np.stack(self.observation_log._values[-(self.window + 1):])
        with self.control_log._lock:
            if len(self.control_log._values) < self.window:
                return None
            ctl = np.stack(self.control_log._values[-self.window :])
        with self.lock:
            log_m, loss = adam(self.window_loss, torch.log(self.masses), self._iters,
                               self._lr, self._tensor(obs[0]), self._tensor(ctl),
                               self._tensor(obs[1:]))
            self.masses = torch.exp(log_m)
            masses = self.masses.cpu().numpy()
        for cb in self._listeners:
            cb(masses, float(loss))
        return masses

    # -- background loop (reference: SSID.cpp:135-140) ------------------------

    def start(self) -> None:
        if self._running:
            return
        self._running = True

        def loop():
            while self._running:
                self.run_inference()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the fit loop; waits for its current fit to end."""
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

"""Marker trace cleaning: despiking and gap filling.

Counterpart of nimblephysics_tpu/biomechanics/marker_fixer.py (numpy
only, copied): the host-side preprocessing the MarkerFitter runs before
IK when asked to (reference: dart/biomechanics/MarkerFixer.hpp).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def clean_marker_traces(
    observed: np.ndarray,  # (T, M, 3), NaN = unobserved
    dt: float,
    max_speed: float = 10.0,  # m/s: faster frame-to-frame motion = spike
    max_gap: int = 10,  # frames: longer gaps stay NaN
    max_accel: float = 1000.0,  # m/s^2: jerk-style ripple threshold
) -> Tuple[np.ndarray, dict]:
    """Despike (velocity/acceleration outliers -> NaN) then fill short
    gaps by linear interpolation. Returns (cleaned, report)."""
    obs = observed.copy().astype(np.float64)
    T, M, _ = obs.shape
    n_spikes = 0
    for m in range(M):
        x = obs[:, m, :]
        seen = ~np.isnan(x[:, 0])
        idx = np.where(seen)[0]
        if len(idx) < 3:
            continue
        # Velocity spikes between consecutive OBSERVED frames.
        d = np.diff(x[idx], axis=0)
        steps = np.diff(idx)[:, None] * dt
        speed = np.linalg.norm(d, axis=1) / np.maximum(steps[:, 0], dt)
        bad = speed > max_speed
        # A spike shows as two consecutive high-speed segments (out and
        # back): kill the middle sample.
        for k in np.where(bad[:-1] & bad[1:])[0]:
            obs[idx[k + 1], m, :] = np.nan
            n_spikes += 1
        # Acceleration ripple on uniformly observed triples.
        x2 = obs[:, m, :]
        seen2 = ~np.isnan(x2[:, 0])
        tri = seen2[:-2] & seen2[1:-1] & seen2[2:]
        acc = np.zeros(T - 2)
        ww = np.where(tri)[0]
        if len(ww):
            a = (x2[ww + 2] - 2 * x2[ww + 1] + x2[ww]) / (dt * dt)
            an = np.linalg.norm(a, axis=1)
            for k, w in enumerate(ww):
                if an[k] > max_accel:
                    obs[w + 1, m, :] = np.nan
                    n_spikes += 1

    # Gap filling.
    n_filled = 0
    for m in range(M):
        x = obs[:, m, :]
        seen = ~np.isnan(x[:, 0])
        idx = np.where(seen)[0]
        if len(idx) < 2:
            continue
        for a, b in zip(idx[:-1], idx[1:]):
            gap = b - a - 1
            if 0 < gap <= max_gap:
                w = np.linspace(0.0, 1.0, gap + 2)[1:-1, None]
                obs[a + 1 : b, m, :] = (1 - w) * x[a] + w * x[b]
                n_filled += gap
    return obs, {"spikes_removed": n_spikes, "gap_frames_filled": n_filled}

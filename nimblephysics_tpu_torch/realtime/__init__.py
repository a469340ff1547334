"""Realtime control (reference: dart/realtime, SURVEY.md 2.6)."""

from nimblephysics_tpu_torch.realtime.buffers import (
    ControlLog,
    ObservationLog,
    RealTimeControlBuffer,
    Ticker,
    VectorLog,
)
from nimblephysics_tpu_torch.realtime.mpc import MPC, MPCLocal, MPCRemote
from nimblephysics_tpu_torch.realtime.ssid import SSID

"""gRPC MPC remoting with the reference's MPCService wire contract.

Copy of nimblephysics_tpu/realtime/mpc_grpc.py, reading the port's own
schemas (nimblephysics_tpu_torch/proto).

Reference parity: the MPCLocal gRPC service (dart/realtime/MPCLocal.hpp:
195-222 — Start / Stop / ListenForUpdates(stream) / RecordGroundTruthState
/ ObserveForce over dart/proto/MPC.proto) and the MPCRemote client proxy
(MPCRemote.hpp:8-66). A reference MPCRemote can connect to this server and
vice versa: the messages come from our bundled wire-compatible schemas
(nimblephysics_tpu_torch/proto) compiled by protoc at first use and served with
grpcio generic handlers — no generated stubs needed.

The plain TCP/JSON transport in realtime/mpc.py remains as the
zero-dependency fallback.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np

_SERVICE = "dart.proto.MPCService"
_MSGS: Optional[Dict[str, type]] = None


def load_messages() -> Dict[str, type]:
    """protoc-compile the bundled schemas -> protobuf message classes."""
    global _MSGS
    if _MSGS is not None:
        return _MSGS
    from google.protobuf import (
        descriptor_pb2,
        descriptor_pool,
        message_factory,
    )

    from nimblephysics_tpu_torch.proto import PROTO_DIR

    fds = descriptor_pb2.FileDescriptorSet()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mpc.desc")
        subprocess.run(
            [
                "protoc",
                f"-I{PROTO_DIR}",
                "Eigen.proto",
                "TrajectoryRollout.proto",
                "MPC.proto",
                "-o",
                out,
                "--include_imports",
            ],
            check=True,
            capture_output=True,
        )
        with open(out, "rb") as f:
            fds.ParseFromString(f.read())
    pool = descriptor_pool.DescriptorPool()
    for fd in fds.file:
        pool.Add(fd)
    names = [
        "VectorXs",
        "MatrixXs",
        "TrajectoryRollout",
        "MPCStartRequest",
        "MPCStartReply",
        "MPCStopRequest",
        "MPCStopReply",
        "MPCListenForUpdatesRequest",
        "MPCListenForUpdatesReply",
        "MPCRecordGroundTruthStateRequest",
        "MPCRecordGroundTruthStateReply",
        "MPCObserveForceRequest",
        "MPCObserveForceReply",
    ]
    _MSGS = {
        n: message_factory.GetMessageClass(
            pool.FindMessageTypeByName(f"dart.proto.{n}")
        )
        for n in names
    }
    return _MSGS


def _vec(M, x) -> "object":
    v = M["VectorXs"]()
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    v.size = x.size
    v.values.extend(x.tolist())
    return v


def _mat(M, x) -> "object":
    m = M["MatrixXs"]()
    x = np.asarray(x, dtype=np.float64)
    m.rows, m.cols = x.shape
    # Eigen (reference SerializeEigen.cpp) stores column-major.
    m.values.extend(x.flatten(order="F").tolist())
    return m


def _mat_to_np(m) -> np.ndarray:
    return np.asarray(m.values, dtype=np.float64).reshape(
        (m.rows, m.cols), order="F"
    )


def serve_mpc_grpc(mpc, port: int, update_hz: float = 20.0):
    """Serve an MPCLocal as the reference MPCService on 127.0.0.1:port
    (port 0 takes a free one). Returns the server; its `bound_port` is
    the port it listens on.

    ListenForUpdates streams the current force plan as a
    TrajectoryRollout (identity mapping, force matrix (nu, horizon))
    whenever a replan lands, tagged with the plan start time in millis.
    """
    import grpc

    M = load_messages()

    def start(request, context):
        mpc.start()
        return M["MPCStartReply"]()

    def stop(request, context):
        mpc.stop()
        return M["MPCStopReply"]()

    def listen(request, context):
        last = -1
        while context.is_active():
            count = getattr(mpc, "_replan_count", 0)
            if count != last:
                last = count
                t0, plan = mpc.buffer.get_plan_copy()
                reply = M["MPCListenForUpdatesReply"]()
                reply.startTime = int(max(t0, 0.0) * 1000)
                ro = reply.rollout
                ro.representationMapping = "identity"
                ro.force["identity"].CopyFrom(_mat(M, np.asarray(plan).T))
                yield reply
            time.sleep(1.0 / update_hz)

    def record_state(request, context):
        state = np.concatenate(
            [np.asarray(request.pos.values), np.asarray(request.vel.values)]
        )
        mpc.record_ground_truth_state(request.time / 1000.0, state)
        return M["MPCRecordGroundTruthStateReply"]()

    def observe_force(request, context):
        if hasattr(mpc, "observe_force"):
            mpc.observe_force(
                request.time / 1000.0, np.asarray(request.force.values)
            )
        return M["MPCObserveForceReply"]()

    def u(fn, req, rep):
        return grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=M[req].FromString,
            response_serializer=lambda m: m.SerializeToString(),
        )

    handlers = {
        "Start": u(start, "MPCStartRequest", "MPCStartReply"),
        "Stop": u(stop, "MPCStopRequest", "MPCStopReply"),
        "ListenForUpdates": grpc.unary_stream_rpc_method_handler(
            listen,
            request_deserializer=M[
                "MPCListenForUpdatesRequest"
            ].FromString,
            response_serializer=lambda m: m.SerializeToString(),
        ),
        "RecordGroundTruthState": u(
            record_state,
            "MPCRecordGroundTruthStateRequest",
            "MPCRecordGroundTruthStateReply",
        ),
        "ObserveForce": u(
            observe_force, "MPCObserveForceRequest", "MPCObserveForceReply"
        ),
    }
    from concurrent import futures

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
    )
    server.bound_port = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    return server


class MPCRemoteGrpc:
    """Reference-parity MPCRemote: gRPC client proxy that mirrors the
    served plan into a local buffer (MPCRemote.hpp semantics)."""

    def __init__(self, host: str, port: int, dt: float):
        import grpc

        self._M = load_messages()
        self._channel = grpc.insecure_channel(f"{host}:{port}")
        self._dt = dt
        self._plan_t0 = 0.0
        self._plan: Optional[np.ndarray] = None  # (horizon, nu)
        self._lock = threading.Lock()
        self._listening = False
        M = self._M

        def rpc(name, req_cls, rep_cls, streaming=False):
            path = f"/{_SERVICE}/{name}"
            if streaming:
                return self._channel.unary_stream(
                    path,
                    request_serializer=lambda m: m.SerializeToString(),
                    response_deserializer=rep_cls.FromString,
                )
            return self._channel.unary_unary(
                path,
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=rep_cls.FromString,
            )

        self._start = rpc("Start", M["MPCStartRequest"], M["MPCStartReply"])
        self._stop = rpc("Stop", M["MPCStopRequest"], M["MPCStopReply"])
        self._listen = rpc(
            "ListenForUpdates",
            M["MPCListenForUpdatesRequest"],
            M["MPCListenForUpdatesReply"],
            streaming=True,
        )
        self._record = rpc(
            "RecordGroundTruthState",
            M["MPCRecordGroundTruthStateRequest"],
            M["MPCRecordGroundTruthStateReply"],
        )

    # -- MPC interface ----------------------------------------------------

    def start(self) -> None:
        M = self._M
        self._start(M["MPCStartRequest"](clientClock=int(time.time())))
        if not self._listening:
            self._listening = True
            threading.Thread(target=self._listen_loop, daemon=True).start()

    def stop(self) -> None:
        M = self._M
        self._listening = False
        self._stop(M["MPCStopRequest"](clientClock=int(time.time())))

    def close(self) -> None:
        """Close the channel (ends the update stream); the proxy is
        unusable after."""
        self._listening = False
        self._channel.close()

    def _listen_loop(self):
        M = self._M
        try:
            for reply in self._listen(M["MPCListenForUpdatesRequest"]()):
                with self._lock:
                    self._plan_t0 = reply.startTime / 1000.0
                    self._plan = _mat_to_np(
                        reply.rollout.force["identity"]
                    ).T  # (horizon, nu)
                if not self._listening:
                    break
        except Exception:
            pass  # channel closed

    def wait_for_plan(self, timeout: float = 5.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if self._plan is not None:
                    return True
            time.sleep(0.01)
        return False

    def get_force(self, t: float) -> np.ndarray:
        with self._lock:
            if self._plan is None:
                raise RuntimeError("no plan received yet")
            k = int(np.clip((t - self._plan_t0) / self._dt, 0,
                            len(self._plan) - 1))
            return self._plan[k].copy()

    def record_ground_truth_state(self, t: float, state: np.ndarray) -> None:
        M = self._M
        state = np.asarray(state, dtype=np.float64)
        nq = state.size // 2
        req = M["MPCRecordGroundTruthStateRequest"](time=int(t * 1000))
        req.pos.CopyFrom(_vec(M, state[:nq]))
        req.vel.CopyFrom(_vec(M, state[nq:]))
        self._record(req)

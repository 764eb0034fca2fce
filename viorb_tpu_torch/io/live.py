"""Live capture transport: a TCP image+IMU wire feeding MsgSynchronizer
(port of viorb_tpu/io/live.py, the same wire byte for byte: a publisher of
either package feeds a source of the other).

Counterpart of the reference's RealTimeDataHandle (reference:
Examples/ROS/ORB_VIO/src/RealTimeDataHandle/ — live camera + 3DM-GX3-25
IMU capture republished over ROS). There is no ROS and no camera hardware
on an accelerator host, so the equivalent is the TRANSPORT: a sensor
process (or machine) publishes length-prefixed binary image/IMU messages
over TCP and `LiveSource` feeds them into the same `MsgSynchronizer` the
replay paths use — the SLAM pipeline is source-agnostic from there
(io/stream.py).

Wire format (little-endian), one message per frame/sample:
    [u32 total_len][u8 kind][f64 ts][payload]
      kind 0 (IMU):   payload = 6 x f32 (gyro xyz, acc xyz)
      kind 1 (IMAGE): payload = u32 h, u32 w, h*w x f32
      kind 2 (BYE):   empty — clean end of stream
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

import numpy as np

from viorb_tpu_torch.io.stream import MsgSynchronizer

_HDR = struct.Struct("<IBd")  # total_len, kind, ts  (len excludes itself)

KIND_IMU = 0
KIND_IMAGE = 1
KIND_BYE = 2


class LivePublisher:
    """Sensor-side: accept one subscriber and push image/IMU messages."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self.address = self._srv.getsockname()
        self._conn: Optional[socket.socket] = None

    def wait_subscriber(self, timeout: float = 30.0):
        self._srv.settimeout(timeout)
        self._conn, _ = self._srv.accept()
        return self

    def _send(self, kind: int, ts: float, payload: bytes):
        if self._conn is None:
            raise RuntimeError("no subscriber connected")
        self._conn.sendall(_HDR.pack(1 + 8 + len(payload), kind, ts) + payload)

    def send_imu(self, ts: float, gyro, acc):
        vals = np.concatenate([np.asarray(gyro, np.float32), np.asarray(acc, np.float32)])
        self._send(KIND_IMU, float(ts), vals.tobytes())

    def send_image(self, ts: float, image):
        img = np.ascontiguousarray(np.asarray(image, np.float32))
        h, w = img.shape
        self._send(KIND_IMAGE, float(ts), struct.pack("<II", h, w) + img.tobytes())

    def close(self):
        if self._conn is not None:
            try:
                self._send(KIND_BYE, 0.0, b"")
            except OSError:
                pass
            self._conn.close()
            self._conn = None
        self._srv.close()


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class LiveSource:
    """SLAM-side: connect to a LivePublisher and pump messages into a
    MsgSynchronizer on a reader thread (host memory only: it never touches
    the card). The synchronizer closes when the stream ends (BYE or
    disconnect), which cleanly stops RealtimeRunner."""

    def __init__(self, host: str, port: int, sync: MsgSynchronizer):
        self.sync = sync
        self._sock = socket.create_connection((host, port), timeout=30.0)
        self.n_images = 0
        self.n_imu = 0
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "LiveSource":
        self._thread.start()
        return self

    def _run(self):
        try:
            while True:
                hdr = _recv_exact(self._sock, _HDR.size)
                if hdr is None:
                    return
                total, kind, ts = _HDR.unpack(hdr)
                payload = _recv_exact(self._sock, total - 1 - 8)
                if payload is None:
                    return
                if kind == KIND_IMU:
                    v = np.frombuffer(payload, np.float32)
                    self.sync.add_imu(ts, v[:3].copy(), v[3:6].copy())
                    self.n_imu += 1
                elif kind == KIND_IMAGE:
                    h, w = struct.unpack("<II", payload[:8])
                    img = np.frombuffer(payload[8:], np.float32).reshape(h, w)
                    self.sync.add_image(ts, img.copy())
                    self.n_images += 1
                elif kind == KIND_BYE:
                    return
        except Exception as e:  # surfaced via join()
            self.error = e
        finally:
            self.sync.close()
            self._sock.close()

    def join(self, timeout: Optional[float] = None):
        self._thread.join(timeout=timeout)
        if self.error is not None:
            raise RuntimeError("live source died") from self.error

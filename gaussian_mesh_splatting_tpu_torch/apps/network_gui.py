"""SIBR remote-viewer bridge (port of
`gaussian_mesh_splatting_tpu/apps/network_gui.py`): the reference's TCP wire
protocol served from the trainer. In: a little-endian uint32 length, then
that many bytes of UTF-8 JSON (resolution, fov, znear/zfar, the view and
view-projection matrices in glm's row-major layout, flags, the scaling
modifier). Out: the frame's raw RGB bytes (none for a 0x0 request), a
little-endian uint32 length and the source path.

The server is an object (`NetworkGUI`) that owns its listening socket and
its viewer connection; `apps.train --port` creates one.
"""
from __future__ import annotations

import json
import math
import socket
import struct

import numpy as np
import torch


class NetworkGUI:
    """A listening socket on (host, port) and at most one viewer connection.
    Binding happens here: an address that cannot be bound raises OSError."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host, self.port = host, port
        self.conn: socket.socket | None = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.listener.bind((host, port))
            self.listener.listen()
        except OSError:
            self.listener.close()
            raise

    def try_connect(self, timeout: float = 0.0) -> bool:
        """True while a viewer is connected; otherwise accept one, waiting up
        to `timeout` seconds (0: only one already waiting)."""
        if self.conn is not None:
            return True
        self.listener.settimeout(timeout)
        try:
            self.conn, _ = self.listener.accept()
        except (BlockingIOError, TimeoutError):
            return False
        print("\nConnected by viewer")
        self.conn.settimeout(None)
        return True

    def _read_bytes(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.conn.recv(n - len(out))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            out += chunk
        return out

    def receive(self) -> dict:
        """One length-prefixed JSON message."""
        (length,) = struct.unpack("<I", self._read_bytes(4))
        return json.loads(self._read_bytes(length).decode("utf-8"))

    def send(self, image_bytes: bytes | None, source_path: str) -> None:
        """Raw RGB bytes (if any) and the length-prefixed source path."""
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(source_path).to_bytes(4, "little"))
        self.conn.sendall(source_path.encode())

    def disconnect(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def close(self) -> None:
        self.disconnect()
        self.listener.close()


def parse_camera(message: dict, device: str | torch.device | None = None):
    """Viewer message -> (Camera on `device`, do_training, keep_alive,
    scaling_modifier), or None for a 0x0 request (the viewer's handshake).
    The matrices arrive row-major in glm's (transposed) convention and are
    transposed into the port's column-vector convention."""
    from ..core.camera import Camera
    from ..device import resolve_device

    width, height = message["resolution_x"], message["resolution_y"]
    if width == 0 or height == 0:
        return None
    dev = resolve_device(device)
    world_view = np.reshape(message["view_matrix"], (4, 4)).T
    full_proj = np.reshape(message["view_projection_matrix"], (4, 4)).T

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    cam = Camera(
        world_view=f32(world_view),
        full_proj=f32(full_proj),
        cam_center=f32(np.linalg.inv(world_view)[:3, 3]),
        tanfovx=f32(math.tan(message["fov_x"] / 2)),
        tanfovy=f32(math.tan(message["fov_y"] / 2)),
        znear=f32(message["z_near"]),
        zfar=f32(message["z_far"]),
        width=int(width),
        height=int(height),
    )
    return cam, bool(message["train"]), bool(message["keep_alive"]), message["scaling_modifier"]


def image_to_bytes(img: np.ndarray) -> bytes:
    """(H, W, 3) float in [0, 1] -> the raw RGB bytes the viewer expects."""
    return (np.clip(img, 0, 1) * 255).astype(np.uint8).tobytes()

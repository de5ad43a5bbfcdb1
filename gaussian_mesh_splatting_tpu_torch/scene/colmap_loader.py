"""COLMAP sparse-reconstruction parsers (binary + text) and the binary
writers (a copy of `gaussian_mesh_splatting_tpu/scene/colmap_loader.py`, in
the same byte layout; points3D.bin through the `fastio` C extension where it
builds, `io/native.py`).

Parses the public COLMAP format (cameras/images/points3D in `.bin`/`.txt`).
Only the fields the pipeline uses are retained.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

# COLMAP camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_BY_NAME = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # (4,) w x y z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP quaternion (w, x, y, z)."""
    K = (
        np.array(
            [
                [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
                [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
                [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1], R[0, 0] + R[1, 1] + R[2, 2]],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_intrinsics_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, model_id, width, height = _read(f, 24, "iiQQ")
            name, np_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * np_params, "d" * np_params))
            cams[cid] = ColmapCamera(cid, name, int(width), int(height), params)
    return cams


def read_extrinsics_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            vals = _read(f, 64, "idddddddi")
            iid = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            cam_id = vals[8]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (n2d,) = _read(f, 8, "Q")
            f.seek(24 * n2d, 1)  # skip 2D points (x, y, point3D_id)
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode("utf-8"))
    return images


def read_points3D_binary(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz (N,3), rgb (N,3) uint8, error (N,1)): parsed by the
    `fastio` C extension where it builds (`io/native.py`), else record by
    record."""
    from ..io.native import fastio

    nat = fastio()
    if nat is not None:
        with open(path, "rb") as f:
            return nat.parse_colmap_points3d(f.read())
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n, 1))
        for i in range(n):
            vals = _read(f, 43, "QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, 1)
    return xyz, rgb, err


def read_intrinsics_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cid = int(tok[0])
            cams[cid] = ColmapCamera(
                cid, tok[1], int(tok[2]), int(tok[3]), np.array([float(x) for x in tok[4:]])
            )
    return cams


def read_extrinsics_text(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    # alternating: image line, 2D-points line
    for i in range(0, len(lines), 2):
        tok = lines[i].split()
        iid = int(tok[0])
        images[iid] = ColmapImage(
            iid,
            np.array([float(x) for x in tok[1:5]]),
            np.array([float(x) for x in tok[5:8]]),
            int(tok[8]),
            tok[9],
        )
    return images


def read_points3D_text(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            xyzs.append([float(x) for x in tok[1:4]])
            rgbs.append([int(x) for x in tok[4:7]])
            errs.append([float(tok[7])])
    return (
        np.array(xyzs),
        np.array(rgbs, np.uint8),
        np.array(errs),
    )


def write_cameras_binary(path: str, cams: dict[int, ColmapCamera]) -> None:
    """Inverse of read_intrinsics_binary (datasets for tests and the smoke run)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            mid, np_params = _MODEL_BY_NAME[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack("<" + "d" * np_params, *c.params[:np_params]))


def write_images_binary(path: str, images: dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3D_binary(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            f.write(
                struct.pack(
                    "<QdddBBBd", i, *xyz[i].tolist(), *rgb[i].tolist(), 0.0
                )
            )
            f.write(struct.pack("<Q", 0))

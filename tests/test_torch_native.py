"""The port's `fastio` C extension (`io/native.py`, `csrc/fastio.c`) against
the numpy readers it stands in for, byte for byte: PLY vertex columns of 1
and 4 bytes (float32, uint8, int32, uint32 through a view), and COLMAP
points3D.bin with track lists of varied length. Truncated files raise; the
build lands under build/, never in native/; without a compiler `load` gives
None and the readers take their numpy paths."""
import os
import struct

import numpy as np
import pytest

from gaussian_mesh_splatting_tpu_torch.io import native
from gaussian_mesh_splatting_tpu_torch.io.ply import read_ply, write_ply
from gaussian_mesh_splatting_tpu_torch.scene.colmap_loader import read_points3D_binary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _points3d(path, n, seed=0):
    """points3D.bin with track lists of 0-5 entries and nonzero errors."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            track = rng.integers(0, 6)
            f.write(struct.pack("<QdddBBBd", i, *rng.standard_normal(3).tolist(),
                                *rng.integers(0, 256, 3).tolist(), float(rng.random())))
            f.write(struct.pack("<Q", track))
            f.write(rng.integers(0, 2**31, 2 * track).astype("<i4").tobytes())


def test_fastio_builds_under_build_not_native():
    assert native.fastio() is not None
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")


def test_ply_columns_equal_the_numpy_reader(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    n = 257
    cols = {"x": rng.standard_normal(n).astype(np.float32),
            "red": rng.integers(0, 256, n).astype(np.uint8),
            "f_dc_0": rng.standard_normal(n).astype(np.float32),
            "label": rng.integers(-5, 5, n).astype(np.int32),
            "flags": rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)}
    path = str(tmp_path / "v.ply")
    write_ply(path, cols)
    fast = read_ply(path)
    monkeypatch.setattr(native, "fastio", lambda: None)
    slow = read_ply(path)
    assert list(fast) == list(slow) == list(cols)
    for k in cols:
        assert fast[k].dtype == slow[k].dtype == cols[k].dtype, k
        assert fast[k].tobytes() == slow[k].tobytes() == cols[k].tobytes(), k


def test_points3d_equal_the_numpy_reader(tmp_path, monkeypatch):
    path = str(tmp_path / "points3D.bin")
    _points3d(path, 300)
    fast = read_points3D_binary(path)
    monkeypatch.setattr(native, "fastio", lambda: None)
    slow = read_points3D_binary(path)
    for a, b in zip(fast, slow):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert fast[0].shape == (300, 3) and fast[2].shape == (300, 1)


@pytest.mark.parametrize("cut", [4, 60, -3])
def test_truncated_points3d_raises(tmp_path, cut):
    path = str(tmp_path / "points3D.bin")
    _points3d(path, 3, seed=2)
    with open(path, "rb") as f:
        data = f.read()
    with pytest.raises(ValueError, match="truncated points3D.bin"):
        native.fastio().parse_colmap_points3d(data[:cut])


def test_short_ply_buffer_raises():
    with pytest.raises(ValueError, match="buffer too small"):
        native.fastio().parse_ply_vertices(b"\0" * 15, 0, 2, [4, 4])


def test_no_compiler_gives_none(tmp_path):
    assert native.load(build_dir=str(tmp_path), cc=str(tmp_path / "no-such-cc")) is None
    assert os.listdir(tmp_path) == []

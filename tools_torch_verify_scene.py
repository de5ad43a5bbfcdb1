#!/usr/bin/env python3
"""The 128x128 toy scene (the port's counterpart of tools_verify_scene.py):
a self-consistent Blender_Mesh dataset whose GT images the port renders from
a known mesh-Gaussian state.

    python3 tools_torch_verify_scene.py ROOT [--device cuda|cpu]

Writes into ROOT: the icosahedron scaled by 1/(2 phi) as `mesh.obj` (20
faces), 8 train and 8 test cameras on a ring (radius 3, height 0.5, the test
ring offset by 0.2 of a step, `camera_angle_x` 0.8, 128x128) as
`transforms_{train,test}.json`, and their GT PNGs. The GT state is the one
the port's `Scene` reader makes of that dataset (`gs_mesh`, 3 splats a face,
SH degree 0: the reader's seeded barycentric weights) with opacity 2.0 and
the SH DC colours GT_F_DC; it is rendered on white through
`renderer.render(..., backend="reference")` on `device` (the card unless
--device cpu; never moved to the CPU on its own). Every file is the JAX
tool's: the same JSON and OBJ text, the same PNGs to the 8-bit rounding of
float32 arithmetic (tests/test_torch_verify_scene.py).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

SIZE = 128  # image edge
N_CAMS = 8  # per split
FOVX = 0.8
RING_RADIUS, RING_HEIGHT, TEST_OFFSET = 3.0, 0.5, 0.2
NUM_SPLATS = 3
SH_DEGREE = 0
GT_OPACITY = 2.0  # raw (pre-sigmoid) opacity of every GT Gaussian

# The GT state's SH DC colours (60 Gaussians x 1 coefficient x RGB), float32:
# the JAX tool draws them as
#   k1, _ = jax.random.split(jax.random.key(42))
#   jax.random.uniform(k1, (60, 1, 3)) * 2 - 0.5
# (threefry, `jax_threefry_partitionable` on). The port keeps the 180 values
# as a constant; tests/test_torch_verify_scene.py draws them again and
# compares.
GT_F_DC = np.array([
    0.5605216, 0.12672424, 1.3030605, 0.8966658, 0.7361312, 0.7437041,
    0.93549347, -0.080599785, -0.45322394, 0.9775214, 0.6722839, 0.5019741,
    1.4040015, 0.6609707, 0.48294067, -0.0077853203, 0.51533794, 0.86278033,
    -0.099543095, 1.1926129, -0.46429753, 0.8335233, -0.010277271, 1.2211728,
    0.6557417, 1.1051087, 1.4309075, 1.024586, 1.3100839, -0.3861847,
    0.501163, 0.29526186, 1.1631429, 0.8286469, 0.014616013, 1.1457698,
    0.24736905, 0.1514337, -0.323771, 0.8621988, 0.7358501, -0.23942351,
    0.42523146, 1.4689577, 0.73582983, 0.497622, 0.28318524, 0.1220808,
    0.6124296, 0.7446308, 0.51535153, 1.4517651, 0.2997923, 1.430459,
    1.114614, 1.0160787, 0.3977003, 0.50227, 0.49802065, 0.095104694,
    1.400795, 1.4574974, 0.4971776, -0.037624836, 1.321867, 0.34956264,
    -0.4777801, 1.1159675, 0.7685597, 1.4822223, 1.1615491, 0.85753775,
    0.42857504, -0.35174084, 1.0369086, 0.55416083, 0.5143442, -0.07887483,
    0.29571033, 0.30725956, 0.16689491, 1.4921429, -0.08706355, 0.8653016,
    -0.22216439, -0.059746742, 0.49078584, 1.4220641, 0.81631947, 0.2871344,
    1.1180634, 0.15754795, 1.0600467, 0.200495, 0.66303277, 0.4898572,
    -0.11950827, 1.0638392, 0.04309535, 0.81334615, 0.1379633, 0.919188,
    0.45181227, 0.67572594, 1.0526257, 0.23970556, 0.5047519, -0.29930115,
    0.8133168, 1.3705742, 1.4616203, 0.37777257, 0.09173012, -0.11566424,
    1.3965414, 0.47131443, 0.11729145, 0.8159764, 0.49621606, -0.28849483,
    1.4232137, 0.53284883, -0.4737234, 0.18069458, -0.28604245, -0.4774742,
    -0.4389553, -0.06901884, 0.9623649, -0.3386712, 0.8586552, -0.36890888,
    1.3371451, -0.46228075, 1.1186881, 0.16279244, 0.51805735, 1.0642402,
    1.0681591, 1.0847912, 0.23194814, 0.36782598, -0.2096591, 0.9813373,
    0.8935418, 0.04662037, 1.3732445, -0.22242546, 0.97208905, 0.17885256,
    0.50035524, 0.44336677, -0.1813488, 1.0028594, -0.018678904, 1.4563632,
    -0.30546546, -0.2699995, 0.22713017, 0.95393753, 0.84951353, -0.1374476,
    1.1804128, 0.013431072, 0.8399823, 0.5903301, 0.8820834, 1.4604611,
    0.72707224, 0.9496372, 0.8297765, 0.7130091, 0.44693828, 0.15854049,
    0.8533788, 1.3032892, 0.23982477, 1.4573164, 1.2393684, 0.26830578,
], np.float32).reshape(60, 1, 3)


def icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """(vertices (12, 3), faces (20, 3) int32): the JAX tool's icosahedron,
    scaled by 1/(2 phi) in the same float arithmetic."""
    phi = (1 + np.sqrt(5)) / 2
    verts = np.array(
        [[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
         [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
         [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
        np.float32) / (2 * phi)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        np.int32)
    return verts, faces


def write_cameras(root: str) -> dict:
    """The two camera rings' transforms JSON and placeholder RGBA PNGs;
    returns {(split, i): PNG path}."""
    from PIL import Image

    paths = {}
    for split, off in [("train", 0.0), ("test", TEST_OFFSET)]:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(N_CAMS):
            angle = 2 * np.pi * (i + off) / N_CAMS
            c = np.array([RING_RADIUS * np.sin(angle), RING_HEIGHT, RING_RADIUS * np.cos(angle)])
            fwd = -c / np.linalg.norm(c)
            up = np.array([0.0, 1.0, 0.0])
            right = np.cross(up, fwd) / np.linalg.norm(np.cross(up, fwd))
            true_up = np.cross(fwd, right)
            c2w = np.eye(4)
            c2w[:3, :3] = np.stack([right, true_up, -fwd], axis=1)
            c2w[:3, 3] = c
            p = os.path.join(root, split, f"r_{i}.png")
            Image.fromarray(np.zeros((SIZE, SIZE, 4), np.uint8), "RGBA").save(p)
            paths[(split, i)] = p
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": FOVX, "frames": frames}, f)
    return paths


def build_scene(root: str, device=None) -> dict:
    """Write the toy dataset into `root` with its GT rendered on `device`
    (default: the card). Returns {"gaussians", "faces", "views", "mean_gt"}."""
    import torch
    from PIL import Image

    from gaussian_mesh_splatting_tpu_torch.device import resolve_device
    from gaussian_mesh_splatting_tpu_torch.io.obj import save_obj
    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.renderer import render
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    dev = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    paths = write_cameras(root)
    verts, faces = icosahedron()
    save_obj(os.path.join(root, "mesh.obj"), verts, faces)

    scene = Scene(root, "gs_mesh", eval=True, num_splats=NUM_SPLATS, shuffle=False, device=dev)
    state = scene.init_model_state(mesh_model, sh_degree=SH_DEGREE)
    params = dict(state["params"])
    if tuple(params["f_dc"].shape) != GT_F_DC.shape:
        raise ValueError(f"the reader made f_dc {tuple(params['f_dc'].shape)}, "
                         f"GT_F_DC is {GT_F_DC.shape}")
    params["f_dc"] = torch.as_tensor(GT_F_DC, device=dev)
    params["opacity"] = torch.full_like(params["opacity"], GT_OPACITY)
    gt_state = {"params": params, "consts": state["consts"], "alive": state["alive"]}
    white = torch.ones(3, device=dev)
    with torch.no_grad():
        bag = mesh_model.to_bag(gt_state)
        for (split, i), p in paths.items():
            cams = scene.train_cameras if split == "train" else scene.test_cameras
            out = render(bag, cams[i][0], white, sh_degree=SH_DEGREE, backend="reference")
            img = torch.clamp(out.image, 0, 1).cpu().numpy()
            rgba = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
            Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(p)
    return {"gaussians": bag.num_gaussians, "faces": int(faces.shape[0]),
            "views": len(paths), "mean_gt": float(img.mean())}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("tools_torch_verify_scene")
    p.add_argument("root", help="directory to write the dataset into")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    info = build_scene(args.root, device=args.device)
    print(f"dataset written: {args.root} ({json.dumps(info)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

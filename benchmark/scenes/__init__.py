"""The inputs of a run, made by the benchmark from its configuration and
`--seed` (never by the program) and handed alike to the program and to the
plain reference: the model's geometry (`scenes/<gs_type>.py`: a mesh, a
FLAME-format head rig, or no faces at all), the cameras, the ground-truth
images and the raw parameters a state starts from, with the mask of the
rows that are alive.

The geometry (mesh, head, camera positions) is fixed by the configuration;
the seed draws the rig's blendshape and corrective bases, the per-splat
weights, the colours, the images and the order of the views, on the device
with one `torch.Generator`, in a few large calls.

A kind's file gives `geometry(config, gen, dev)`, and may give
`gaussians(config, traffic, gen, dev)`, its own per-Gaussian parameters and
alive mask (a buffer of more rows than are alive), in place of the
mesh-bound ones of `gaussian_params`; and `learning_rates(config, extent)`,
each parameter's rate as a number or as a function of the step, in place of
the configuration's constant "learning_rates".
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import random

import numpy as np
import torch

GOLDEN_ANGLE = math.pi * (3.0 - math.sqrt(5.0))


@dataclasses.dataclass
class Scene:
    kind: str  # the configuration's gs_type: scenes/<kind>.py, program/<kind>.py, ...
    width: int
    height: int
    fovx: float
    fovy: float
    views: list  # (R, T) per view: camera-to-world rotation (COLMAP axes), world-to-view shift
    gt: torch.Tensor | None  # (n_views, H, W, 3), train views only
    bg: torch.Tensor  # (3,)
    params: dict  # raw parameters the state starts from
    alive: torch.Tensor  # (rows,) bool: the rows of `params` that hold a Gaussian
    faces: torch.Tensor  # (F, 3) int64; (0, 3) for a kind not on a mesh
    rig: dict | None  # the model's further tensors (the FLAME-format rig of gs_flame)
    n_vertices: int
    sh_degree: int
    lambda_dssim: float
    lr: dict  # learning rate of each parameter: a number, or a function of the step
    start_step: int
    cameras_extent: float  # the Blender reader's NeRF normalisation radius of the train views

    @property
    def n_gaussians(self) -> int:
        """The rows of the parameters, alive or not."""
        return int(self.params["opacity"].shape[0])

    def learning_rates(self, step: int) -> dict:
        """Each parameter's learning rate for update number `step` (0-based,
        the state's step counter before the update)."""
        return {k: v(step) if callable(v) else v for k, v in self.lr.items()}


def hemisphere_views(n: int, radius: float, elevation_deg, azimuth_offset: float) -> list:
    """n cameras on the upper hemisphere (z up, Blender's world), spread
    evenly in the sine of the elevation and by the golden angle in azimuth,
    each looking at the origin; as (R, T) the way the Blender reader turns a
    transform matrix into them."""
    s0, s1 = (math.sin(math.radians(e)) for e in elevation_deg)
    out = []
    for i in range(n):
        z = s0 + (s1 - s0) * (i + 0.5) / n
        az = i * GOLDEN_ANGLE + azimuth_offset
        c = radius * np.array([math.sqrt(1 - z * z) * math.cos(az),
                               math.sqrt(1 - z * z) * math.sin(az), z])
        back = c / np.linalg.norm(c)
        right = np.cross([0.0, 0.0, 1.0], back)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(back, right), back], axis=1)
        c2w[:3, 3] = c
        c2w[:3, 1:3] *= -1  # Blender -> COLMAP camera axes
        w2c = np.linalg.inv(c2w)
        out.append((w2c[:3, :3].T.copy(), w2c[:3, 3].copy()))
    return out


def cameras_extent(views: list) -> float:
    """The radius of the Blender reader's NeRF normalisation
    (`scene/dataset_readers.get_nerfpp_norm`): 1.1 times the largest distance
    of a camera centre from the centres' mean, the centres taken from the
    float32 world-to-view matrices as the reader takes them."""
    centers = []
    for R, T in views:
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = R.T, T
        centers.append(np.linalg.inv(w2c.astype(np.float32))[:3, 3])
    centers = np.stack(centers)
    return float(np.linalg.norm(centers - centers.mean(axis=0), axis=1).max() * 1.1)


def expon_lr(lr_init: float, lr_final: float, max_steps: int):
    """The 3DGS position schedule (Plenoxels' log-linear decay, no delay
    steps) as step -> rate, in float32 as the port's `core/lr_schedule`
    evaluates it: lr_init at step 0, lr_final from `max_steps` on."""
    def rate(step: int) -> float:
        t = torch.clamp(torch.tensor(step, dtype=torch.float32) / max_steps, 0, 1)
        init, final = (torch.log(torch.tensor(x, dtype=torch.float32)) for x in (lr_init, lr_final))
        return float(torch.exp(init * (1 - t) + final * t))

    return rate


def smooth_images(gen: torch.Generator, n: int, height: int, width: int, dev) -> torch.Tensor:
    """(n, H, W, 3) images in [0, 1]: 0.5 plus four plane waves a channel,
    of 0.5 to 3 cycles an image."""
    amp = torch.rand((n, 1, 1, 3, 4), generator=gen, device=dev) * 0.12
    fx = (torch.rand((n, 1, 1, 3, 4), generator=gen, device=dev) * 2 - 1) * 3
    fy = (torch.rand((n, 1, 1, 3, 4), generator=gen, device=dev) * 2 - 1) * 3
    ph = torch.rand((n, 1, 1, 3, 4), generator=gen, device=dev) * 2 * math.pi
    u = (torch.arange(width, device=dev, dtype=torch.float32) / width)[None, None, :, None]
    v = (torch.arange(height, device=dev, dtype=torch.float32) / height)[None, :, None, None]
    img = torch.full((n, height, width, 3), 0.5, device=dev)
    for j in range(4):
        img += amp[..., j] * torch.sin(2 * math.pi * (fx[..., j] * u + fy[..., j] * v) + ph[..., j])
    return img.clamp_(0.0, 1.0)


def gaussian_params(gen: torch.Generator, n_faces: int, splats: int, sh_degree: int,
                    state: str, dev) -> dict:
    """Per-Gaussian raw parameters. "initial": the readers' start (uniform
    barycentric seeds, near-grey colours, no view dependence, opacity 0.1,
    scale 1); "trained": trained-looking colours and view dependence,
    opacity sigmoid(2.5)."""
    n, k = n_faces * splats, (sh_degree + 1) ** 2
    p = {"alpha": torch.rand((n_faces, splats, 3), generator=gen, device=dev),
         "scale": torch.ones((n, 1), device=dev)}
    if state == "initial":
        p["f_dc"] = torch.rand((n, 1, 3), generator=gen, device=dev) / 255.0
        p["f_rest"] = torch.zeros((n, k - 1, 3), device=dev)
        p["opacity"] = torch.full((n, 1), math.log(0.1 / 0.9), device=dev)
    elif state == "trained":
        p["f_dc"] = torch.rand((n, 1, 3), generator=gen, device=dev) * 2 - 0.5
        p["f_rest"] = torch.randn((n, k - 1, 3), generator=gen, device=dev) * 0.08
        p["opacity"] = torch.full((n, 1), 2.5, device=dev)
    else:
        raise ValueError(f"unknown state {state!r}")
    return p


def build(config: dict, traffic: dict, seed: int, dev) -> Scene:
    """The scene of one run of a cell: `config` the configuration's file,
    `traffic` the traffic mix's. The geometry and the model's own parameters
    come from `scenes/<gs_type>.py`, found by the configuration's `gs_type`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % (1 << 63))
    kind = config["gs_type"]
    module = importlib.import_module(f".{kind}", __name__)
    geo = module.geometry(config, gen, dev)
    faces = geo["faces"]
    params = dict(geo["params"])
    alive = None
    if hasattr(module, "gaussians"):
        own = module.gaussians(config, traffic, gen, dev)
        params.update(own["params"])
        alive = own["alive"]
    else:
        params.update(gaussian_params(gen, faces.shape[0], config["num_splats"],
                                      config["sh_degree"], traffic["state"], dev))
    extent = cameras_extent(hemisphere_views(config["train_views"], config["camera_radius"],
                                             config["elevation_deg"], 0.0))
    lr = (module.learning_rates(config, extent) if hasattr(module, "learning_rates")
          else dict(config["learning_rates"]))
    split = traffic["views"]
    n_views = config[f"{split}_views"]
    offset = 0.0 if split == "train" else GOLDEN_ANGLE / 2
    views = hemisphere_views(n_views, config["camera_radius"], config["elevation_deg"], offset)
    w, h = config["width"], config["height"]
    fovx = config["camera_angle_x"]
    fovy = 2 * math.atan(h / (2 * (w / (2 * math.tan(fovx / 2)))))
    gt = smooth_images(gen, n_views, h, w, dev) if traffic["ground_truth"] else None
    bg = torch.full((3,), 1.0 if config["white_background"] else 0.0, device=dev)
    if alive is None:  # made after the images, so as not to add to their peak
        alive = torch.ones(params["opacity"].shape[0], dtype=torch.bool, device=dev)
    return Scene(kind=kind, width=w, height=h, fovx=fovx, fovy=fovy, views=views, gt=gt, bg=bg,
                 params=params, alive=alive, faces=faces, rig=geo["rig"],
                 n_vertices=geo["n_vertices"], sh_degree=config["sh_degree"],
                 lambda_dssim=config["lambda_dssim"], lr=lr, start_step=config["start_step"],
                 cameras_extent=extent)


def check_counts(stated: dict, built: dict) -> None:
    """Raise where the mesh that was built has other counts of faces or
    vertices than the configuration states."""
    for key, value in built.items():
        if key in stated and stated[key] != value:
            raise ValueError(f"the mesh has {value} {key}; the configuration states "
                             f"{stated[key]}")


def view_order(seed: int, n_views: int, order: str):
    """The traffic's views, one after another without end: "shuffle_pop"
    pops from a list reshuffled by `random.Random(seed)` whenever it runs
    out (apps/train's order); "in_order" walks them in turn from a start
    drawn from the seed."""
    rng = random.Random(seed)
    if order == "shuffle_pop":
        pool: list[int] = []
        while True:
            if not pool:
                pool = list(range(n_views))
                rng.shuffle(pool)
            yield pool.pop()
    elif order == "in_order":
        i = rng.randrange(n_views)
        while True:
            yield i
            i = (i + 1) % n_views
    else:
        raise ValueError(f"unknown view order {order!r}")

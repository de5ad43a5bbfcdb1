"""The mesh kinds' inputs pinned: at one seed, `scenes.build` gives each tiny
configuration the tensors it gave before a kind could make its own
parameters (the digests below were recorded from that version of the
benchmark), so the generator's draws keep their order and every existing
cell measures what it measured."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark import scenes
from benchmark.tests.tiny import BENCH, tiny_config

SEED = 2**31 + 17
# sha256 of each tensor's bytes, first 16 hex digits
PINNED = {
    "gs_mesh_nerf_synthetic/train_views": {
        "params.vertices": "b40ae62085f58207",
        "params.alpha": "fdd498c260b79523",
        "params.scale": "e67f1f457024f99b",
        "params.f_dc": "d119b6de6ed77b60",
        "params.f_rest": "ec7cac6f1999b693",
        "params.opacity": "295a69003013e87a",
        "faces": "c4a986f90222a513",
        "gt": "ccfab954485f1748",
        "views": "d9d12af1ef6a9b3c",
    },
    "gs_mesh_nerf_synthetic/test_views": {
        "params.vertices": "b40ae62085f58207",
        "params.alpha": "fdd498c260b79523",
        "params.scale": "e67f1f457024f99b",
        "params.f_dc": "d119b6de6ed77b60",
        "params.f_rest": "ec7cac6f1999b693",
        "params.opacity": "295a69003013e87a",
        "faces": "c4a986f90222a513",
        "gt": None,
        "views": "84f5816a44b69ccf",
    },
    "gs_flame_head/train_views_initial": {
        "params.flame_shape": "7a12e561363385e9",
        "params.flame_exp": "6d9c54dee5660c46",
        "params.flame_pose": "9d908ecfb6b256de",
        "params.flame_neck_pose": "15ec7bf0b50732b4",
        "params.flame_trans": "15ec7bf0b50732b4",
        "params.vertices_enlargement": "674d57250cb39673",
        "params.alpha": "eb7ef53dd4fe91cc",
        "params.scale": "c65c4e133489ec1b",
        "params.f_dc": "948e795112a146a0",
        "params.f_rest": "cd3a89d5d4db6606",
        "params.opacity": "b51fc87736fa6652",
        "faces": "538f07b8abcfa2e8",
        "gt": "3213a3cc86662c28",
        "rig.v_template": "855f15227e95464f",
        "rig.shapedirs": "50f90f1c4830c755",
        "rig.posedirs": "e345d930d0074263",
        "rig.j_regressor": "92e6ccd2a944290b",
        "rig.lbs_weights": "e1ecfca9d03b6195",
        "views": "d9d12af1ef6a9b3c",
    },
}


def digest(a) -> str:
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else a
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", list(PINNED))
def test_mesh_kinds_inputs_are_unchanged(cell):
    config, traffic = cell.split("/")
    c = tiny_config(_json("configs", f"{config}.json"))
    s = scenes.build(c, _json("traffic", f"{traffic}.json"), SEED, torch.device("cpu"))
    got = {f"params.{k}": digest(v) for k, v in s.params.items()}
    got["faces"] = digest(s.faces)
    got["gt"] = None if s.gt is None else digest(s.gt)
    got.update({f"rig.{k}": digest(v) for k, v in (s.rig or {}).items() if torch.is_tensor(v)})
    got["views"] = digest(np.stack([np.concatenate([R.ravel(), T]) for R, T in s.views]))
    assert got == PINNED[cell]
    assert s.alive.dtype == torch.bool and s.alive.shape == (s.n_gaussians,)
    assert bool(s.alive.all())
    assert s.learning_rates(s.start_step) == c["learning_rates"]
    assert s.cameras_extent > 0


def test_extent_and_position_schedule_are_the_ports():
    """`cameras_extent` is the Blender reader's normalisation radius of the
    train views, and `expon_lr` the port's position schedule, bit for bit."""
    from types import SimpleNamespace

    from gaussian_mesh_splatting_tpu_torch.core.lr_schedule import make_expon_lr_schedule
    from gaussian_mesh_splatting_tpu_torch.scene.dataset_readers import get_nerfpp_norm

    c = tiny_config(_json("configs", "gs_mesh_nerf_synthetic.json"))
    s = scenes.build(c, _json("traffic", "test_views.json"), SEED, torch.device("cpu"))
    train = scenes.hemisphere_views(c["train_views"], c["camera_radius"], c["elevation_deg"], 0.0)
    want = get_nerfpp_norm([SimpleNamespace(R=R, T=T) for R, T in train])["radius"]
    assert s.cameras_extent == float(want)
    init, final = 0.00016 * s.cameras_extent, 0.0000016 * s.cameras_extent
    ours = scenes.expon_lr(init, final, 30_000)
    port = make_expon_lr_schedule(init, final, lr_delay_mult=0.01, max_steps=30_000)
    for step in (0, 1, 500, 3000, 29_999, 30_000, 40_000):
        assert ours(step) == port(step)

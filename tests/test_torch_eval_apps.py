"""The port's evaluation apps on the CPU: `apps.metrics` against the JAX
package's on one tree of PNGs (the same JSON keys; SSIM, PSNR and LPIPS
within 1e-5, LPIPS from one weights file through $GMS_LPIPS_WEIGHTS, null in
both without it), and `apps.full_eval` over a nerf-synthetic suite of eight
symlinks to one tiny dataset (train -> render -> metrics per scene)."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gaussian_mesh_splatting_tpu.apps import metrics as j_metrics
from gaussian_mesh_splatting_tpu_torch.apps import full_eval as t_full_eval
from gaussian_mesh_splatting_tpu_torch.apps import metrics as t_metrics
from gaussian_mesh_splatting_tpu_torch.io.ply import store_point_cloud
from gaussian_mesh_splatting_tpu_torch.ops.lpips import synthetic_arrays
from test_io_scene import _make_blender_dataset

torch.set_num_threads(2)
TOL = 1e-5


def _png_tree(model, seed):
    """{model}/test/ours_7/ with two renders directories and gt/: 32x32 PNGs,
    renders near the GT so that the scores are not degenerate."""
    rng = np.random.default_rng(seed)
    base = os.path.join(model, "test", "ours_7")
    for d in ("gt", "renders_gs_flat", "renders_gs_points"):
        os.makedirs(os.path.join(base, d))
    for i in range(2):
        gt = rng.random((32, 32, 3))
        Image.fromarray((gt * 255).astype(np.uint8)).save(os.path.join(base, "gt", f"{i:05d}.png"))
        for d, noise in (("renders_gs_flat", 0.1), ("renders_gs_points", 0.3)):
            img = np.clip(gt + rng.normal(0, noise, gt.shape), 0, 1)
            Image.fromarray((img * 255).astype(np.uint8)).save(os.path.join(base, d, f"{i:05d}.png"))


def _results(model):
    out = {}
    for kind in ("results", "per_view"):
        for gs_type in ("gs_flat", "gs_points"):
            with open(os.path.join(model, f"{kind}_{gs_type}.json")) as f:
                out[f"{kind}_{gs_type}"] = json.load(f)
    return out


def _flat(d, prefix=()):
    """{(key path): leaf} of a nested dict."""
    if isinstance(d, dict):
        return {k: v for key, sub in d.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: d}


@pytest.mark.parametrize("weights", [True, False], ids=["lpips", "no_weights"])
def test_metrics_app_matches_jax(tmp_path, monkeypatch, capsys, weights):
    path = str(tmp_path / "lpips_vgg.npz")
    if weights:
        np.savez(path, **synthetic_arrays(np.random.default_rng(0)))
    monkeypatch.setenv("GMS_LPIPS_WEIGHTS", path)
    j_model, t_model = str(tmp_path / "jax"), str(tmp_path / "port")
    _png_tree(j_model, 1)
    _png_tree(t_model, 1)
    j_metrics.main(["-m", j_model])
    t_metrics.main(["-m", t_model, "--device", "cpu"])
    if not weights:
        assert capsys.readouterr().out.count("LPIPS weights not found") == 2
    ref, got = _flat(_results(j_model)), _flat(_results(t_model))
    assert sorted(got) == sorted(ref)
    # each file holds the results walked so far (the JAX app's layout)
    assert {k[2] for k in got if k[-1] == "LPIPS"} == {"gs_flat", "gs_points"}
    for k, want in ref.items():
        if weights or "LPIPS" not in k:
            assert np.isfinite(got[k]) and abs(got[k] - want) <= TOL, (k, got[k], want)
        else:
            assert got[k] is None and want is None, k
    if weights:
        flat = got[("results_gs_flat", "ours_7", "gs_flat", "LPIPS")]
        points = got[("results_gs_points", "ours_7", "gs_points", "LPIPS")]
        assert 0 < flat < points  # more noise scores higher


def test_full_eval_harness(tmp_path):
    """Eight nerf-synthetic scene names, all symlinks to one tiny dataset:
    each gets a trained, rendered and scored model directory."""
    base = tmp_path / "ns"
    real = str(base / "real_scene")
    _make_blender_dataset(real, n_cams=2, size=16)
    rng = np.random.default_rng(0)
    store_point_cloud(os.path.join(real, "points3d.ply"), rng.normal(size=(48, 3)) * 0.5,
                      rng.integers(0, 255, (48, 3)))
    for name in t_full_eval.NERF_SYNTHETIC:
        os.symlink(real, str(base / name))
    out = str(tmp_path / "eval")
    t_full_eval.main(["--gs_type", "gs_flat", "-ns", str(base), "-o", out, "--iterations", "2",
                      "--device", "cpu"])
    for name in t_full_eval.NERF_SYNTHETIC:
        with open(os.path.join(out, name, "results_gs_flat.json")) as f:
            r = json.load(f)
        assert np.isfinite(r["ours_2"]["gs_flat"]["PSNR"]), name
        assert len(os.listdir(os.path.join(out, name, "test", "ours_2", "renders_gs_flat"))) == 2

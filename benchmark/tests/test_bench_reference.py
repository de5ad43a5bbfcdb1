"""The plain reference against the port's CPU path (`backend="auto"`, the
kernels' plain versions) at tiny sizes: the model's Gaussians, the FLAME
decode, the render, the loss, Adam and a density-control event (and that
event on the card at 400,000 rows)."""
import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import program, scenes
from benchmark.drivers.train import _to as to_device, density_numbers
from benchmark.reference import camera, densify, exact_float32, loss, models, render, train
from benchmark.reference.models.gs_flame import flame_vertices
from benchmark.tests.tiny import BENCH, DENSITY_LIMITS, tiny_config

from gaussian_mesh_splatting_tpu_torch.core.transforms import quat_to_rotmat
from gaussian_mesh_splatting_tpu_torch.renderer import render as port_render
from gaussian_mesh_splatting_tpu_torch.train import make_train_state, optimization_config
from gaussian_mesh_splatting_tpu_torch.train.loss import photometric_loss

DEV = torch.device("cpu")


def scene(config: str, state: str = "trained", seed: int = 7):
    with open(os.path.join(BENCH, "configs", f"{config}.json")) as f:
        c = tiny_config(json.load(f))
    traffic = {"driver": "train", "views": "train", "state": state, "ground_truth": True}
    return scenes.build(c, traffic, seed, DEV)


def covariance(rot, scale):
    m = rot * scale[:, None, :]
    return m @ m.transpose(1, 2)


@pytest.mark.parametrize("config", ["gs_mesh_nerf_synthetic", "gs_flame_head"])
def test_bag_matches_the_port(config):
    s = scene(config)
    s.params = {k: v + 0.05 * torch.randn_like(v) if k.startswith("flame_") else v
                for k, v in s.params.items()}
    want = program.model_for(s).to_bag(program.model_state(s))
    got = models.bag_for(s.kind, s.params, s.faces, s.rig, s.alive)
    torch.testing.assert_close(got["xyz"], want.xyz, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got["scale"], want.scaling, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(got["opacity"], want.opacity[:, 0])
    torch.testing.assert_close(got["sh"], want.shs.transpose(1, 2))
    cov = covariance(quat_to_rotmat(want.rotation), want.scaling)
    torch.testing.assert_close(covariance(got["rot"], got["scale"]), cov, rtol=1e-4,
                               atol=1e-5 * float(cov.abs().max()))


def test_flame_decode_moves_with_every_parameter():
    s = scene("gs_flame_head")
    base = flame_vertices(s.params, s.rig)
    for key in ("flame_shape", "flame_exp", "flame_pose", "flame_neck_pose", "flame_trans"):
        p = dict(s.params, **{key: s.params[key] + 0.1})
        assert float((flame_vertices(p, s.rig) - base).abs().max()) > 1e-6, key


@pytest.mark.parametrize("config", ["gs_mesh_nerf_synthetic", "gs_flame_head"])
def test_render_matches_the_port(config):
    s = scene(config)
    bag = program.model_for(s).to_bag(program.model_state(s))
    cams = program.cameras(s, DEV)
    ref_bag = models.bag_for(s.kind, s.params, s.faces, s.rig, s.alive)
    for i in range(len(s.views)):
        want = port_render(bag, cams[i], s.bg, sh_degree=3, backend="auto").image
        view = camera.make_view(*s.views[i], s.fovx, s.fovy, s.width, s.height, DEV)
        got = render.render(ref_bag, view, s.bg)
        assert float((got - want).abs().max()) < 1e-4
        assert float((got - want).square().mean().sqrt()) < 1e-5


def test_chunked_composite_does_not_depend_on_the_chunk():
    s = scene("gs_mesh_nerf_synthetic")
    bag = models.bag_for(s.kind, s.params, s.faces, s.rig, s.alive)
    view = camera.make_view(*s.views[0], s.fovx, s.fovy, s.width, s.height, DEV)
    proj = render.project(bag, view)
    bins = render.bin_tiles(proj, s.height, s.width)
    small, whole = (list(render.chunks(bins, e)) for e in (1 << 11, 1 << 24))
    assert len(small) > len(whole) >= 1
    images = [render.composite(proj, bins, s.height, s.width, s.bg, e) for e in (1 << 11, 1 << 24)]
    torch.testing.assert_close(images[0], images[1], rtol=0, atol=1e-6)


def test_loss_matches_the_port():
    g = torch.Generator().manual_seed(3)
    a, b = torch.rand((40, 48, 3), generator=g), torch.rand((40, 48, 3), generator=g)
    want, _ = photometric_loss(a, b, 0.2)
    torch.testing.assert_close(loss.photometric(a, b, 0.2), want, rtol=1e-5, atol=1e-7)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(4)
    p0 = torch.randn(50, generator=g)
    grads = [torch.randn(50, generator=g) for _ in range(3)]
    p = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=0.01, betas=train.BETAS, eps=train.EPS)
    q, m, v = p0.clone(), torch.zeros(50), torch.zeros(50)
    for t, gr in enumerate(grads, start=1):
        p.grad = gr.clone()
        opt.step()
        train.adam_step(q, gr, m, v, t, 0.01)
    torch.testing.assert_close(q, p.detach(), rtol=1e-6, atol=1e-7)


def test_training_steps_match_the_port():
    s = scene("gs_mesh_nerf_synthetic", state="initial")
    trainer = program.Trainer(s)
    losses = [float(trainer.step(i)) for i in (0, 1, 2)]
    ref = train.train_steps(s, [0, 1, 2])
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k, p in trainer.params().items():
        torch.testing.assert_close(p.detach() - s.params[k], ref["change"][k], rtol=1e-3, atol=1e-5)


def test_flame_head_has_flames_counts_and_open_boundaries():
    """The gs_flame head as configured: FLAME's 5,023 vertices and 9,976
    faces, every vertex used, every face outward, and open at the neck and
    at two eye slots (every other edge shared by two faces)."""
    from benchmark.scenes.gs_flame import head_mesh

    with open(os.path.join(BENCH, "configs", "gs_flame_head.json")) as f:
        fl = json.load(f)["flame"]
    verts, faces = head_mesh(fl["vertices"], fl["faces"], fl["neck_deg"], fl["eye_faces"],
                             fl["eye_polar_deg"], fl["eye_azimuth_deg"])
    assert verts.shape == (5023, 3) and faces.shape == (9976, 3)
    assert len(np.unique(faces)) == 5023
    normal = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]], verts[faces[:, 2]] - verts[faces[:, 0]])
    assert ((normal * verts[faces].mean(1)).sum(1) > 0).all()
    edges = np.sort(faces[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
    _, uses = np.unique(edges, axis=0, return_counts=True)
    assert set(uses) == {1, 2}
    neck = 2 * 5023 - 2 - 9976 - 2 * fl["eye_faces"]
    # boundary edges: the neck ring and two slots, each of its faces + 2 edges
    assert (uses == 1).sum() == neck + 2 * (fl["eye_faces"] + 2)


def density_case(seed: int, rows: int, alive: int, cols: int, size_threshold: float,
                 reset: bool, dev) -> tuple:
    """(state, plan, noise) of a seeded density-control event of `gs` (3
    scale columns) or `gs_flat` (2): `alive` live rows of `rows` in random
    places, scales from 0.005 to 0.5 about an extent of 3 (so both clones
    and splits, and world-size prunes), opacities from under min_opacity
    up, gradients of four values (ties, broken by row order), screen radii
    up to 40, and both Adam moments of every group."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=dev)

    params = {"xyz": normal(rows, 3), "f_dc": normal(rows, 1, 3),
              "f_rest": 0.1 * normal(rows, 15, 3),
              "opacity": 2.5 * normal(rows, 1) - 1.0,
              "scaling": math.log(0.005) + math.log(100.0) * uniform(rows, cols),
              "rotation": normal(rows, 4)}
    live = torch.randperm(rows, generator=g, device=dev) < alive
    state = make_train_state({"params": params, "alive": live, "consts": {}},
                             optimization_config("gs" if cols == 3 else "gs_flat"), 3.0)
    state.step = 1100
    denom = torch.randint(0, 6, (rows,), generator=g, device=dev).float()
    levels = torch.tensor([1e-4, 2e-4, 3e-4, 6e-4], device=dev)
    state.stats.grad_accum = denom * levels[torch.randint(0, 4, (rows,), generator=g, device=dev)]
    state.stats.denom = denom
    state.stats.max_radii = 40.0 * uniform(rows)
    opt = state.optimizer
    for group in opt.param_groups:
        p = group["params"][0]
        opt.state[p] = {"step": torch.tensor(7.0), "exp_avg": 1e-3 * normal(*p.shape),
                        "exp_avg_sq": 1e-6 * uniform(*p.shape)}
    args = dict(grad_threshold=2e-4, min_opacity=0.005, extent=3.0, percent_dense=0.01,
                size_threshold=size_threshold, scaling_cols=cols, n_split=program.N_SPLIT)
    noise = normal(program.N_SPLIT, rows, 3)
    return state, {"densify": args, "reset": reset}, noise


def replay(state, plan: dict, noise: torch.Tensor) -> tuple[dict, dict]:
    """The port's event on `state` and the reference's on a copy of it from
    before: (compared numbers, diagnostics) of `density_numbers`."""
    before = program.snapshot(state)
    state, event = program.density_event(state, plan, noise=noise)
    after = dict(program.snapshot(state), counts=event)
    exact_float32()
    want = densify.density_event(before, plan, noise.cpu())
    return density_numbers(after, want)


@pytest.mark.parametrize("reset", [False, True], ids=["densify", "with_reset"])
@pytest.mark.parametrize("alive,overflow", [(100, False), (360, True)], ids=["room", "overflow"])
@pytest.mark.parametrize("size_threshold", [0.0, 20.0], ids=["size_off", "size_on"])
@pytest.mark.parametrize("cols", [3, 2], ids=["gs", "gs_flat"])
def test_densify_matches_the_port(cols, size_threshold, alive, overflow, reset):
    """The plain densify reference against the port's `densify_and_prune`
    (then `reset_opacity`) on seeded random states with the same noise:
    alive masks and counts equal, params and moments within the tiny
    densifying cell's limits."""
    state, plan, noise = density_case(int(cols * 1000 + size_threshold * 10 + alive + reset),
                                      400, alive, cols, size_threshold, reset, DEV)
    numbers, diagnostics = replay(state, plan, noise)
    counts = diagnostics["counts"]
    assert counts == diagnostics["reference_counts"]
    assert counts["n_clone"] > 0 and counts["n_split_rows"] > 0
    assert counts["n_pruned_opacity"] > 0 and (counts["n_pruned_world"] > 0) == (size_threshold > 0)
    assert (counts["overflow"] > 0) == overflow
    assert ("opacity_reset" in counts) == reset
    for k, limit in DENSITY_LIMITS.items():
        assert numbers[k] <= limit, (k, numbers[k], diagnostics)


@pytest.mark.card
def test_densify_matches_the_port_on_the_card(card):
    """The reference test's largest case at `gs.train_densify`'s 400,000
    rows on the card: `gs`, size pruning on, an overflowing buffer, the
    port's event on CUDA tensors. Prints the four numbers and the event's
    time; holds them to the tiny cell's limits."""
    state, plan, noise = density_case(2026, 400_000, 360_000, 3, 20.0, False, card)
    program.density_event(*density_case(7, 400_000, 360_000, 3, 20.0, False, card)[:2],
                          noise=noise)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    before = program.snapshot(state)
    start.record()
    state, event = program.density_event(state, plan, noise=noise)
    end.record()
    torch.cuda.synchronize()
    after = dict(program.snapshot(state), counts=event)
    exact_float32()
    want = densify.density_event(to_device(before, card), plan, noise)
    numbers, diagnostics = density_numbers(to_device(after, card), want)
    print("density_card", json.dumps({"numbers": numbers, "counts": event,
                                      "event_ms": start.elapsed_time(end),
                                      "param_gaps": diagnostics["param_gaps"],
                                      "moment_gaps": diagnostics["moment_gaps"]}))
    assert event["overflow"] > 0
    for k, limit in DENSITY_LIMITS.items():
        assert numbers[k] <= limit, (k, numbers[k])

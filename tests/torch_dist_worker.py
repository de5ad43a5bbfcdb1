"""Ranks of the port's parallel tests (not a test file).

`spawn(cases, world, tmp_path)` starts `world` processes with the spawn
method; each joins a gloo process group through a `file://` store under
`tmp_path` (no TCP port, so concurrent test workers cannot collide), runs
every case, saves its results to `tmp_path/rank<r>.pt` and leaves the group.
`cases` maps a key to `(name, kwargs)`, `name` a function of this module
called as `fn(rank, world, **kwargs)`; it returns tensors, numbers, strings
and containers of them, which the rank's results hold under the key. Inputs
come in as numpy arrays.

This module imports torch and the port only: a spawned rank imports it to
find its case, and should not pay for JAX.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gaussian_mesh_splatting_tpu_torch.interop import camera_from_numpy, state_from_numpy
from gaussian_mesh_splatting_tpu_torch.models import flat
from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import rasterize_cuda
from gaussian_mesh_splatting_tpu_torch.parallel import (
    create_mesh,
    create_mesh2d,
    local_batch_slice,
    make_dp_train_step,
    make_sharded_train_step,
    multihost,
    render_gaussian_sharded,
    render_row_sharded,
)
from gaussian_mesh_splatting_tpu_torch.parallel.collectives import all_reduce_flat
from gaussian_mesh_splatting_tpu_torch.train import make_train_state, optimization_config

SH_C0 = 0.28209479177387814


# ---------------------------------------------------------------- scenes (numpy)

def flat_scene(seed: int, n: int, *, spread: float = 0.6, log_scale: float = -1.6,
               opacity_logit: float | None = None) -> dict:
    """Raw `gs_flat` params (SH degree 0) of n seeded Gaussians, numpy
    float32, in the layout both packages share, and the alive mask."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((n, 3)) * spread
    cols = rng.random((n, 3))
    scaling = rng.standard_normal((n, 2)) * 0.2 + log_scale
    opacity = rng.uniform(-1.0, 2.0, (n, 1)) if opacity_logit is None \
        else np.full((n, 1), opacity_logit)
    params = {
        "xyz": xyz, "f_dc": ((cols - 0.5) / SH_C0)[:, None, :],
        "f_rest": np.zeros((n, 0, 3)), "opacity": opacity, "scaling": scaling,
        "rotation": np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
    }
    return {"params": {k: v.astype(np.float32) for k, v in params.items()},
            "alive": np.ones((n,), bool)}


def ring_pose(i: int, n: int, dist_: float = 4.0) -> tuple[np.ndarray, np.ndarray]:
    """(R, T) of camera i of n on a ring in the xz plane, looking at the
    origin (the JAX tests' `_cameras_around`)."""
    angle = 2 * np.pi * i / n
    c = np.array([dist_ * np.sin(angle), 0.0, -dist_ * np.cos(angle)])
    fwd = -c / np.linalg.norm(c)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    rc2w = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    return rc2w, -rc2w.T @ c


def camera_fields(cam) -> dict:
    """A camera of either package as the numpy mapping `camera_from_numpy`
    takes."""
    return {f.name: np.asarray(getattr(cam, f.name)) for f in dataclasses.fields(cam)}


# ---------------------------------------------------------------- spawning

def _rank_main(cases, rank, world, out_dir, init_kwargs):
    torch.set_num_threads(1)
    ok = multihost.initialize(f"file://{os.path.join(out_dir, 'store')}", world_size=world,
                              rank=rank, backend="gloo", **init_kwargs)
    results = {"initialized": ok and multihost.is_initialized(),
               "again": multihost.initialize()}  # idempotent
    for key, (name, kwargs) in cases.items():
        results[key] = globals()[name](rank, world, **kwargs)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn(cases: dict[str, tuple[str, dict]], world: int, tmp_path,
          timeout: float = 600.0, init_kwargs: dict | None = None) -> list:
    """Run `cases` on `world` gloo ranks; returns each rank's results. A rank
    that fails ends the others (they would wait in a collective).
    `init_kwargs` go to `multihost.initialize` (e.g. the group's `timeout`)."""
    out_dir = str(tmp_path)
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(cases, r, world, out_dir, init_kwargs or {}))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(world)]


# ---------------------------------------------------------------- cases

def _leaf_params(scene: dict) -> dict:
    return {k: torch.tensor(v, requires_grad=True) for k, v in scene["params"].items()}


def _bag(params: dict, scene: dict):
    return flat.to_bag({"params": params, "consts": {}, "alive": torch.tensor(scene["alive"])})


_SHARDED_RENDER = {"rows": render_row_sharded, "gaussians": render_gaussian_sharded}


def render(rank, world, *, shard, scene, cam, bg):
    """The sharded render and the unsharded one, on each rank."""
    mesh = create_mesh()
    cam = camera_from_numpy(cam, device="cpu")
    bg = torch.tensor(bg)
    with torch.no_grad():
        bag = _bag(_leaf_params(scene), scene)
        sharded = _SHARDED_RENDER[shard](bag, cam, bg, mesh, sh_degree=0)
        full = rasterize_cuda(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam, bg=bg,
                              shs=bag.shs, sh_degree=0, alive=bag.alive)
    return {"sharded": sharded, "full": full.image, "alpha": full.alpha}


def render_grads(rank, world, *, shard, scene, cam):
    """Gradients of mean(image^2) through the sharded render (summed over
    the ranks) and through the unsharded one."""
    mesh = create_mesh()
    cam = camera_from_numpy(cam, device="cpu")
    bg = torch.zeros(3)
    params = _leaf_params(scene)
    (_SHARDED_RENDER[shard](_bag(params, scene), cam, bg, mesh, sh_degree=0) ** 2).mean() \
        .backward()
    grads = dict(zip(params, all_reduce_flat([p.grad for p in params.values()],
                                             mesh.get_group())))
    ref = _leaf_params(scene)
    bag = _bag(ref, scene)
    out = rasterize_cuda(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam, bg=bg,
                         shs=bag.shs, sh_degree=0, alive=bag.alive)
    (out.image ** 2).mean().backward()
    return {"grads": grads, "ref": {k: p.grad for k, p in ref.items()}}


def train_steps(rank, world, *, mode, scene, cams, gts, bg, steps=1, n_model=2,
                pair_capacity=None):
    """`steps` train steps of a parallel mode on gs_flat (SH 0), from a
    fresh state: the loss, the (reduced) gradients and the statistics of the
    first step, the losses of all, and the final params.

    mode: "data" (rank r takes camera r), "rows" / "gaussians" (every rank
    camera 0), "composed" (a (world / n_model) x n_model mesh, sharded over
    gaussians; model group d takes camera d). Later steps cycle the cameras."""
    cfg = optimization_config("gs_flat")
    state = make_train_state(state_from_numpy("gs_flat", scene, device="cpu"), cfg)
    kw = {} if pair_capacity is None else {"pair_capacity": pair_capacity}
    if mode == "data":
        step = make_dp_train_step(flat, cfg, 0, create_mesh(), render_kwargs=kw)
        pick = rank
    elif mode == "composed":
        mesh = create_mesh2d(world // n_model, n_model)
        step = make_sharded_train_step(flat, cfg, 0, mesh, shard="gaussians", model_axis="model",
                                       data_axis="data", render_kwargs=kw)
        pick = mesh.get_local_rank("data")
    else:
        step = make_sharded_train_step(flat, cfg, 0, create_mesh(), shard=mode, render_kwargs=kw)
        pick = 0
    cams = [camera_from_numpy(c, device="cpu") for c in cams]
    gts = [torch.tensor(g) for g in gts]
    bg = torch.tensor(bg)
    n_cams = len(cams)
    out = {"losses": [], "overflow": []}
    for i in range(steps):
        c = (pick + i) % n_cams
        state, metrics = step(state, cams[c], gts[c], bg)
        out["losses"].append(float(metrics["loss"]))
        out["overflow"].append(metrics["overflow"])
        if i == 0:
            out["metrics"] = {k: float(v) for k, v in metrics.items()}
            out["grads"] = {k: p.grad.clone() for k, p in state.params.items()}
            out["stats"] = {k: getattr(state.stats, k).clone()
                            for k in ("grad_accum", "denom", "max_radii")}
    out["params"] = {k: p.detach().clone() for k, p in state.params.items()}
    out["step"] = state.step
    return out


def meshes(rank, world, *, batch):
    """The 2-D mesh's groups and each rank's camera slice."""
    mesh2 = create_mesh2d(world // 2, 2)
    mesh1 = create_mesh()
    sub = create_mesh(2)
    return {
        "model": dist.get_process_group_ranks(mesh2.get_group("model")),
        "data": dist.get_process_group_ranks(mesh2.get_group("data")),
        "slice": local_batch_slice(batch, mesh1),
        "sub_slice": local_batch_slice(batch, sub),
        "global": multihost.global_mesh().size(),
    }


def scaling(rank, world, *, iters):
    """`measure_scaling` of a DP step on a tiny scene (one camera a rank)."""
    scene = flat_scene(3, 16)
    cfg = optimization_config("gs_flat")
    from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera

    def builder(mesh):
        state = make_train_state(state_from_numpy("gs_flat", scene, device="cpu"), cfg)
        cam = make_camera(*ring_pose(rank, world), 0.9, 0.9, 16, 16, device="cpu")
        step = make_dp_train_step(flat, cfg, 0, mesh)
        return step, (state, cam, torch.full((16, 16, 3), 0.5), torch.zeros(3))

    return multihost.measure_scaling(builder, iters=iters)


_WRITES: dict = {}  # the running app case's model root and the paths it opened for writing


def _audit_writes(event, args):
    root = _WRITES.get("root")
    if root is None or event not in ("open", "os.mkdir"):
        return
    if not isinstance(args[0], (str, bytes, os.PathLike)):
        return  # a file descriptor
    path = os.path.realpath(os.fsdecode(args[0]))
    if event == "open":
        mode, flags = args[1], args[2]
        if not (any(c in mode for c in "wax+") if mode else
                flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
            return
    if path.startswith(root + os.sep):
        _WRITES["paths"].add(os.path.relpath(path, root))


def train_app(rank, world, *, argv, model_path):
    """`apps.train.main(argv)` on each rank: its stdout, the files it opened
    for writing (and the directories it made) under `model_path`, and the
    run's losses, densify events and final state."""
    import contextlib
    import io
    import sys

    from gaussian_mesh_splatting_tpu_torch.apps import train as train_app_module

    if not _WRITES:
        sys.addaudithook(_audit_writes)  # for the rest of this rank's life
    _WRITES.update(root=os.path.realpath(model_path), paths=set())
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            res = train_app_module.main(argv)
    finally:
        writes = sorted(_WRITES["paths"])
        _WRITES["root"] = None
    state = res.state
    return {
        "stdout": out.getvalue(), "writes": writes, "losses": res.losses,
        "densify_events": res.densify_events, "test_psnr": res.test_psnr,
        "params": {k: p.detach().clone() for k, p in state.params.items()},
        "alive": state.alive.clone(), "step": state.step,
    }


def _viewer_request(train: bool) -> dict:
    """An 8x8 SIBR viewer request from 4 units out (the format of
    `apps/network_gui.parse_camera`)."""
    view = np.eye(4)
    view[3, 2] = 4.0  # glm's row-vector convention: the translation in row 3
    return {"resolution_x": 8, "resolution_y": 8, "train": train, "fov_y": 0.8,
            "fov_x": 0.8, "z_near": 0.01, "z_far": 100.0, "shs_python": False,
            "rot_scale_python": False, "keep_alive": True, "scaling_modifier": 1.0,
            "view_matrix": view.reshape(-1).tolist(),
            "view_projection_matrix": np.eye(4).reshape(-1).tolist()}


def train_app_paused(rank, world, *, argv, model_path, port, pause_s):
    """`train_app` with `--port port`; on rank 0 a viewer connects before the
    first step (the loop's first poll waits for it), unchecks "train" for
    `pause_s` seconds, taking frames, and then resumes. Adds the viewer's
    frame count and pause length to rank 0's results."""
    import json
    import socket
    import struct
    import threading

    from gaussian_mesh_splatting_tpu_torch.apps.network_gui import NetworkGUI

    argv = [*argv, "--port", str(port)]
    if rank != 0:
        return train_app(rank, world, argv=argv, model_path=model_path)
    viewer = {"frames": 0}

    def recv(c, n):
        out = b""
        while len(out) < n:
            chunk = c.recv(n - len(out))
            if not chunk:
                raise ConnectionError("the trainer closed the viewer's connection")
            out += chunk
        return out

    def request(c, train):
        payload = json.dumps(_viewer_request(train)).encode()
        c.sendall(struct.pack("<I", len(payload)) + payload)
        recv(c, 8 * 8 * 3)
        recv(c, struct.unpack("<I", recv(c, 4))[0])

    def run():
        deadline = time.monotonic() + 60
        while True:  # rank 0 binds the port at its start
            try:
                c = socket.create_connection(("127.0.0.1", port), timeout=60)
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)
        with c:
            request(c, train=False)  # answered at the loop's first poll
            viewer["frames"], t0 = 1, time.monotonic()
            while time.monotonic() - t0 < pause_s:
                request(c, train=False)
                viewer["frames"] += 1
                time.sleep(0.05)
            viewer["pause_s"] = time.monotonic() - t0
            request(c, train=True)

    polls = []
    real_try_connect = NetworkGUI.try_connect

    def first_poll_waits(self, timeout=0.0):
        polls.append(timeout)
        return real_try_connect(self, 60.0 if len(polls) == 1 else timeout)

    NetworkGUI.try_connect = first_poll_waits
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        res = train_app(rank, world, argv=argv, model_path=model_path)
    finally:
        NetworkGUI.try_connect = real_try_connect
    thread.join(30)
    return {**res, "viewer": viewer, "viewer_done": not thread.is_alive()}

"""Training CLI (port of `gaussian_mesh_splatting_tpu/apps/train.py`, the
single-device paths: `gs_mesh`, `gs_multi_mesh`, `gs_flame`, and `gs` /
`gs_flat` with densification).

    python -m gaussian_mesh_splatting_tpu_torch.apps.train \\
        --gs_type gs|gs_flat|gs_mesh|gs_multi_mesh|gs_flame -s <dataset> -m <output> \\
        [--eval] [--device cpu] ...

The dataset is a Blender one (`transforms_*.json`; with `mesh.obj` for
`gs_mesh`) or a COLMAP one (`sparse/0`; `gs_multi_mesh` trains on its
`sparse/0/*.obj` meshes, or those `--meshes` names; `--images` names the
image directory). `gs_flame` trains on a Blender dataset and needs
`--flame_model <FLAME pickle>`.

Flow: Scene (writes `input.ply` and `cameras.json`) -> initial state (for
`gs` / `gs_flat` a buffer of `--capacity_mult` times the point count) or the
state of `--start_checkpoint` -> `cfg_args` -> one train step per camera, in
an order reshuffled from `random.Random(seed)` whenever it runs out (it
starts anew on a resume) -> SH warm-up every 1000 iterations, density control
(`gs` / `gs_flat`), periodic eval, snapshots, checkpoints (`chkpnt{N}.pt`).
Runs on the CUDA device (preprocess, binning and the two composite kernels)
unless `--device cpu` is given, which takes the kernels' plain PyTorch
versions.

`--seed` seeds the camera order, the random backgrounds and the generator of
the split samples, a `torch.Generator` on the run's device: a CPU run and a
CUDA run draw different samples from one seed.

Flags whose paths are not ported raise NotImplementedError: `--port`,
`--profile_steps`, `--detect_anomaly`, `--shard`/`--data_parallel` with more
than one device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import random
import time

import numpy as np
import torch


@dataclasses.dataclass
class TrainResult:
    """What `main` returns: the final state, the loss of every step, the
    mean test PSNR of every eval ({iteration: psnr}), and the counts of every
    densify event ({"iteration", and the keys of `densify_and_prune`'s info})."""

    state: object
    losses: list[float]
    test_psnr: dict[int, float]
    densify_events: list[dict]


def checkpoint_path(model_path: str, iteration: int) -> str:
    return os.path.join(model_path, f"chkpnt{iteration}.pt")


def dump_debug_state(model_path: str, it: int, tstate, cam) -> str:
    """Dump the params, alive mask, consts and camera matrices after a
    non-finite loss, to replay the step offline."""
    out = os.path.join(model_path, f"debug_dump_{it}.npz")
    flat = {"step": np.asarray(tstate.step)}
    for group in ("params", "consts"):
        for k, v in getattr(tstate, group).items():
            if isinstance(v, list):  # one tensor per mesh
                flat.update({f"{group}/{k}/{i}": t.detach().cpu().numpy()
                             for i, t in enumerate(v)})
            else:
                flat[f"{group}/{k}"] = v.detach().cpu().numpy()
    flat["alive"] = tstate.alive.cpu().numpy()
    for attr in ("world_view", "full_proj", "cam_center"):
        flat[f"camera/{attr}"] = getattr(cam, attr).cpu().numpy()
    np.savez(out, **flat)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train")
    p.add_argument("--gs_type", default="gs",
                   choices=["gs", "gs_flat", "gs_mesh", "gs_multi_mesh", "gs_flame"])
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--images", "-i", default="images")
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--num_splats", type=int, default=2)
    p.add_argument("--meshes", nargs="*", default=None)
    p.add_argument("--flame_model", default=None, help="path to flame pickle")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--lambda_dssim", type=float, default=None)
    p.add_argument("--densify_grad_threshold", type=float, default=None)
    p.add_argument("--densification_interval", type=int, default=None)
    p.add_argument("--densify_from_iter", type=int, default=None)
    p.add_argument("--densify_until_iter", type=int, default=None)
    p.add_argument("--opacity_reset_interval", type=int, default=None)
    p.add_argument("--random_background", action="store_true")
    p.add_argument("--test_iterations", nargs="+", type=int,
                   default=[7_000, 20_000, 30_000, 60_000, 90_000])
    p.add_argument("--save_iterations", nargs="+", type=int,
                   default=[7_000, 20_000, 30_000, 60_000, 90_000])
    p.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    p.add_argument("--start_checkpoint", default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--detect_anomaly", action="store_true")
    p.add_argument("--save_xyz", action="store_true",
                   help="save raw Gaussian centers to <model>/xyz/<it>.npy every 5000 iters")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", action="store_true")
    p.add_argument("--shard", default="none", choices=["none", "data", "rows", "gaussians"])
    p.add_argument("--backend", default="auto", choices=["auto", "cuda", "reference"],
                   help="auto: the CUDA kernels on the card, their plain versions on the "
                        "CPU; reference: the sequential torch oracle")
    p.add_argument("--capacity_mult", type=float, default=4.0,
                   help="densify buffer headroom over the initial point count")
    p.add_argument("--pair_capacity", type=int, default=None,
                   help="initial rasterizer pair-list size (default: exact, no overflow); "
                        "doubles whenever a step drops pairs")
    p.add_argument("--port", type=int, default=0, help="network GUI port (0 disables)")
    p.add_argument("--profile_steps", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _refuse_unported(args, n_devices: int) -> None:
    unported = {
        "--port": args.port,
        "--profile_steps": args.profile_steps,
        "--detect_anomaly": args.detect_anomaly,
    }
    for flag, value in unported.items():
        if value:
            raise NotImplementedError(f"{flag} is not ported yet")
    if (args.shard != "none" or args.data_parallel) and n_devices > 1:
        raise NotImplementedError("multi-device training (--shard, --data_parallel) "
                                  "is not ported yet")


def main(argv=None) -> TrainResult:
    args = build_parser().parse_args(argv)
    from ..device import resolve_device
    from ..io.checkpoint import restore_checkpoint, save_checkpoint, snapshot_dir
    from ..io.config_io import save_cfg
    from ..io.snapshots import save_snapshot
    from ..models import model_for
    from ..scene import Scene
    from ..train import (
        densify_and_prune,
        make_eval_render,
        make_train_state,
        make_train_step,
        one_up_sh_degree,
        optimization_config,
        psnr,
        reset_opacity,
    )
    from ..utils.profiling import MetricsLogger

    device = resolve_device(args.device)
    # float32 stays float32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    random.seed(args.seed)
    np.random.seed(args.seed)

    model, flame_rig = model_for(args.gs_type, args.flame_model, device)
    overrides = {
        k: getattr(args, k)
        for k in ["iterations", "lambda_dssim", "densify_grad_threshold",
                  "densification_interval", "densify_from_iter",
                  "densify_until_iter", "opacity_reset_interval"]
        if getattr(args, k) is not None
    }
    if args.random_background:
        overrides["random_background"] = True
    cfg = optimization_config(args.gs_type, **overrides)
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    _refuse_unported(args, n_devices)
    if args.pair_capacity is not None and args.pair_capacity <= 0:
        raise ValueError("--pair_capacity must be positive")

    scene = Scene(
        args.source_path, args.gs_type, model_path=args.model_path,
        white_background=args.white_background, eval=args.eval,
        resolution=args.resolution, images=args.images, num_splats=args.num_splats,
        meshes=args.meshes, flame_rig=flame_rig, seed=args.seed, device=device,
    )
    densify = getattr(cfg, "densify", False)
    n0 = len(scene.scene_info.point_cloud.points)
    capacity = int(n0 * args.capacity_mult) if densify else None
    mstate = scene.init_model_state(model, sh_degree=args.sh_degree, capacity=capacity)
    tstate = make_train_state(mstate, cfg, scene.cameras_extent)
    if args.start_checkpoint:
        tstate = restore_checkpoint(args.start_checkpoint, tstate)
        print(f"resumed from {args.start_checkpoint} at step {tstate.step} "
              f"({int(tstate.alive.sum())} alive of {tstate.alive.shape[0]} rows)")
    save_cfg(args.model_path, {
        "gs_type": args.gs_type, "source_path": os.path.abspath(args.source_path),
        "model_path": args.model_path, "images": args.images,
        "resolution": args.resolution, "white_background": args.white_background,
        "sh_degree": args.sh_degree, "eval": args.eval,
        "num_splats": args.num_splats, "meshes": args.meshes,
        "flame_model": args.flame_model,
    })

    # the pair list is sized exactly unless --pair_capacity bounds it; the
    # overflow count is a host int, so the bound grows right after the step
    # that dropped pairs
    pair_capacity = args.pair_capacity

    def build_step(cap):
        rkw = {"pair_capacity": cap} if cap is not None else {}
        return make_train_step(model, cfg, args.sh_degree, backend=args.backend,
                               render_kwargs=rkw)

    step_fn = build_step(pair_capacity)
    eval_fn = make_eval_render(model, args.sh_degree, backend=args.backend)

    bg_color = torch.full((3,), 1.0 if args.white_background else 0.0, device=device)
    rng = random.Random(args.seed)
    np_rng = np.random.default_rng(args.seed)
    densify_rng = torch.Generator(device=device).manual_seed(args.seed)
    # every GT image on the device up front (800x800 float32 is 7.7 MB)
    cams = [(c, torch.as_tensor(g, device=device)) for c, g in scene.train_cameras]
    order: list[int] = []
    logger = MetricsLogger(args.model_path, tensorboard=True)
    if args.save_xyz:
        os.makedirs(os.path.join(args.model_path, "xyz"), exist_ok=True)

    losses: list[torch.Tensor] = []
    test_psnr: dict[int, float] = {}
    densify_events: list[dict] = []
    t_start = t_boundary = time.time()
    it_boundary = start_iter = tstate.step
    ema_loss = None
    for it in range(start_iter + 1, cfg.iterations + 1):
        if args.save_xyz and (it % 5000 == 1 or it == cfg.iterations):
            with torch.no_grad():
                xyz = model.to_bag(tstate.model_state()).xyz
            np.save(os.path.join(args.model_path, "xyz", f"{it}.npy"), xyz.cpu().numpy())
        if it % 1000 == 0:
            one_up_sh_degree(tstate, args.sh_degree)
        if cfg.random_background:
            bg = torch.as_tensor(np_rng.random(3), dtype=torch.float32, device=device)
        else:
            bg = bg_color
        if not order:
            order = list(range(len(cams)))
            rng.shuffle(order)
        cam, gt = cams[order.pop()]
        tstate, metrics = step_fn(tstate, cam, gt, bg)
        losses.append(metrics["loss"])

        if metrics["overflow"] > 0 and pair_capacity is not None:
            pair_capacity *= 2
            print(f"[it {it}] rasterizer pair overflow ({metrics['overflow']} pairs dropped): "
                  f"growing pair_capacity to {pair_capacity}")
            step_fn = build_step(pair_capacity)

        if densify and it < cfg.densify_until_iter:
            if it > cfg.densify_from_iter and it % cfg.densification_interval == 0:
                tstate, info = densify_and_prune(
                    tstate,
                    grad_threshold=cfg.densify_grad_threshold,
                    min_opacity=cfg.min_opacity,
                    extent=scene.cameras_extent,
                    percent_dense=cfg.percent_dense,
                    # screen/world-size pruning starts after the first opacity reset
                    size_threshold=20.0 if it > cfg.opacity_reset_interval else 0.0,
                    scaling_cols=2 if args.gs_type == "gs_flat" else 3,
                    generator=densify_rng,
                )
                # the event's one host read of its counts
                info = dict(zip(info, torch.stack(list(info.values())).tolist()))
                densify_events.append({"iteration": it, **info})
                if not args.quiet and info["overflow"] > 0:
                    print(f"[it {it}] densify overflow: {info['overflow']} dropped")
                if not args.quiet and info["n_pruned"] > 0.5 * max(info["n_alive"], 1):
                    print(f"[it {it}] WARNING: densify pruned {info['n_pruned']} "
                          f"(opacity {info['n_pruned_opacity']}, "
                          f"screen {info['n_pruned_screen']}, "
                          f"world {info['n_pruned_world']}) — {info['n_alive']} alive")
            if it % cfg.opacity_reset_interval == 0 or (
                args.white_background and it == cfg.densify_from_iter
            ):
                tstate = reset_opacity(tstate)

        if it % 100 == 0 or it == 1:
            loss = float(metrics["loss"])
            ema_loss = loss if ema_loss is None else 0.6 * loss + 0.4 * ema_loss
            iter_ms = (time.time() - t_boundary) / max(it - it_boundary, 1) * 1000
            t_boundary, it_boundary = time.time(), it
            if not args.quiet:
                print(f"[it {it}/{cfg.iterations}] loss {ema_loss:.5f} "
                      f"psnr {float(metrics['psnr']):.2f} iter {iter_ms:.1f}ms "
                      f"({time.time() - t_start:.0f}s)")
            if not np.isfinite(loss):
                dump = dump_debug_state(args.model_path, it, tstate, cam)
                raise RuntimeError(f"non-finite loss at iteration {it}; state dumped to {dump}")
            if it % 100 == 0:
                logger.scalar("train_loss_patches/total_loss", loss, it)
                logger.scalar("train_loss_patches/l1_loss", float(metrics["l1"]), it)
                logger.scalar("iter_time", iter_ms, it)
                logger.scalar("rasterizer/pair_overflow", metrics["overflow"], it)
                logger.scalar("total_points", float(tstate.alive.sum()), it)

        if it in args.test_iterations and scene.test_cameras:
            vals = []
            for idx, (tc, tgt) in enumerate(scene.test_cameras):
                img = eval_fn(tstate, tc, bg_color)
                vals.append(float(psnr(img, torch.as_tensor(tgt, device=device))))
                if idx < 5:
                    logger.image(f"test_view_{idx}/render", img.cpu().numpy(), it)
            test_psnr[it] = float(np.mean(vals))
            print(f"[it {it}] eval: test PSNR {test_psnr[it]:.2f}")
            logger.scalar("test/psnr", test_psnr[it], it)
            logger.histogram("scene/opacity_histogram",
                             torch.sigmoid(tstate.params["opacity"]).detach().cpu().numpy(), it)
            logger.flush()

        if it in args.save_iterations:
            out_dir = snapshot_dir(args.model_path, it)
            save_snapshot(args.gs_type, model, tstate.model_state(), out_dir)
            print(f"[it {it}] saved snapshot to {out_dir}")

        if it in args.checkpoint_iterations:
            save_checkpoint(checkpoint_path(args.model_path, it), tstate)
            print(f"[it {it}] checkpoint saved")

    if cfg.iterations not in args.save_iterations:
        save_snapshot(args.gs_type, model, tstate.model_state(),
                      snapshot_dir(args.model_path, cfg.iterations))
    logger.close()
    print(f"training done in {time.time() - t_start:.0f}s")
    return TrainResult(
        state=tstate,
        losses=torch.stack(losses).tolist() if losses else [],
        test_psnr=test_psnr,
        densify_events=densify_events,
    )


if __name__ == "__main__":
    main()

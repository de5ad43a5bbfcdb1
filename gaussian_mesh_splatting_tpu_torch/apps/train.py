"""Training CLI (port of `gaussian_mesh_splatting_tpu/apps/train.py`, the
single-device `gs_mesh` path).

    python -m gaussian_mesh_splatting_tpu_torch.apps.train \\
        --gs_type gs_mesh -s <dataset> -m <output> [--eval] [--device cpu] ...

Flow: Scene (writes `input.ply` and `cameras.json`) -> initial state ->
`cfg_args` -> one train step per camera, in an order reshuffled from
`random.Random(seed)` whenever it runs out -> SH warm-up every 1000
iterations, periodic eval, snapshots. Runs on the CUDA device (preprocess,
binning and the two composite kernels) unless `--device cpu` is given, which
takes the kernels' plain PyTorch versions.

Flags whose paths are not ported raise NotImplementedError: `--port`,
`--profile_steps`, `--checkpoint_iterations`, `--start_checkpoint`,
`--detect_anomaly`, `--shard`/`--data_parallel` with more than one device,
a gs_type other than `gs_mesh`, and a config with densification.
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
    """What `main` returns: the final state, the loss of every step, and the
    mean test PSNR of every eval ({iteration: psnr})."""

    state: object
    losses: list[float]
    test_psnr: dict[int, float]


def dump_debug_state(model_path: str, it: int, tstate, cam) -> str:
    """Dump the params, alive mask, consts and camera matrices after a
    non-finite loss, to replay the step offline."""
    out = os.path.join(model_path, f"debug_dump_{it}.npz")
    flat = {"step": np.asarray(tstate.step)}
    for group in ("params", "consts"):
        for k, v in getattr(tstate, group).items():
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
    p.add_argument("--pair_capacity", type=int, default=None,
                   help="initial rasterizer pair-list size (default: exact, no overflow); "
                        "doubles whenever a step drops pairs")
    p.add_argument("--port", type=int, default=0, help="network GUI port (0 disables)")
    p.add_argument("--profile_steps", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _refuse_unported(args, cfg, n_devices: int) -> None:
    unported = {
        "--port": args.port,
        "--profile_steps": args.profile_steps,
        "--checkpoint_iterations": args.checkpoint_iterations,
        "--start_checkpoint": args.start_checkpoint,
        "--detect_anomaly": args.detect_anomaly,
    }
    for flag, value in unported.items():
        if value:
            raise NotImplementedError(f"{flag} is not ported yet")
    if (args.shard != "none" or args.data_parallel) and n_devices > 1:
        raise NotImplementedError("multi-device training (--shard, --data_parallel) "
                                  "is not ported yet")
    if getattr(cfg, "densify", False):
        raise NotImplementedError("densification is not ported yet")


def main(argv=None) -> TrainResult:
    args = build_parser().parse_args(argv)
    from ..device import resolve_device
    from ..io.checkpoint import snapshot_dir
    from ..io.config_io import save_cfg
    from ..io.snapshots import save_snapshot
    from ..models import get_model
    from ..scene import Scene
    from ..train import (
        make_eval_render,
        make_train_state,
        make_train_step,
        one_up_sh_degree,
        optimization_config,
        psnr,
    )
    from ..utils.profiling import MetricsLogger

    device = resolve_device(args.device)
    # float32 stays float32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    random.seed(args.seed)
    np.random.seed(args.seed)

    model = get_model(args.gs_type)
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
    _refuse_unported(args, cfg, n_devices)
    if args.pair_capacity is not None and args.pair_capacity <= 0:
        raise ValueError("--pair_capacity must be positive")

    scene = Scene(
        args.source_path, args.gs_type, model_path=args.model_path,
        white_background=args.white_background, eval=args.eval,
        resolution=args.resolution, num_splats=args.num_splats,
        seed=args.seed, device=device,
    )
    tstate = make_train_state(scene.init_model_state(model, sh_degree=args.sh_degree), cfg,
                              scene.cameras_extent)
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
    # every GT image on the device up front (800x800 float32 is 7.7 MB)
    cams = [(c, torch.as_tensor(g, device=device)) for c, g in scene.train_cameras]
    order: list[int] = []
    logger = MetricsLogger(args.model_path, tensorboard=True)
    if args.save_xyz:
        os.makedirs(os.path.join(args.model_path, "xyz"), exist_ok=True)

    losses: list[torch.Tensor] = []
    test_psnr: dict[int, float] = {}
    t_start = t_boundary = time.time()
    it_boundary = 0
    ema_loss = None
    for it in range(1, cfg.iterations + 1):
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

    if cfg.iterations not in args.save_iterations:
        save_snapshot(args.gs_type, model, tstate.model_state(),
                      snapshot_dir(args.model_path, cfg.iterations))
    logger.close()
    print(f"training done in {time.time() - t_start:.0f}s")
    return TrainResult(
        state=tstate,
        losses=torch.stack(losses).tolist() if losses else [],
        test_psnr=test_psnr,
    )


if __name__ == "__main__":
    main()

"""Training CLI (port of `gaussian_mesh_splatting_tpu/apps/train.py`:
`gs_mesh`, `gs_multi_mesh`, `gs_flame`, and `gs` / `gs_flat` with
densification, on one device or, one process per device, on several).

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

The GT images stay on the device when they fit a quarter of its free memory
(`gt_budget`), else they stay in pinned host memory and each step copies its
image over (`place_gt`). The loss is read on the host at iteration 1 and
every 100th (every iteration under `--detect_anomaly`, which also turns on
`torch.autograd`'s anomaly mode for the run); before each step that reads it
the loop keeps a detached copy of the step's inputs, which a non-finite loss
dumps to `{model}/debug_dump_<it>.npz` before the run raises.
`--profile_steps START:STOP` traces steps START..STOP with `torch.profiler`
into `{model}/profile/trace.json` and records the port's spans and counts
over them (`utils/profiling.Recording`) into `{model}/profile/spans.json`;
`--port` serves the SIBR viewer's frames from the training loop
(`apps/network_gui.py`, on `--ip`).

Parallel modes (`parallel/`), one process per device under `torchrun`:

    torchrun --nproc_per_node N -m gaussian_mesh_splatting_tpu_torch.apps.train \\
        ... --shard data|rows|gaussians        # --data_parallel = --shard data

`--shard data` renders one camera per rank a step (the step's cameras are
the next N of the seeded order, rank r takes the r-th) and averages the
gradients; `rows` and `gaussians` render one camera a step in portions (tile
rows; depth slabs of the Gaussians) and reassemble it. The processes join
through `parallel.multihost.initialize` (NCCL on the card; gloo with
`--device cpu`). Every rank runs the same loop on the same replicated state,
densifying with the same seeded generator, and at the end every rank holds
its state's digest to the others' (`parallel.multihost.check_replicas`; a
rank that drifted is an error); only rank 0 writes the model
directory (cfg_args, input.ply, cameras.json, metrics, snapshots,
checkpoints, debug dumps, the profile trace), prints, evaluates the test
views and serves the viewer. Meanwhile the other ranks wait in the next
step's first collective; with `--port`, in a barrier at the top of every
iteration instead, on a gloo group whose timeout is `VIEWER_PAUSE_LIMIT`, so
that a viewer may pause training for longer than the job's process group
would wait in a collective. A job of one process trains as a single device
does; more than one visible card with a sharding flag and no process group
is an error.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os
import random
import time
import traceback

import numpy as np
import torch

# how long a viewer may pause a run of several processes (see the docstring)
VIEWER_PAUSE_LIMIT = datetime.timedelta(days=7)


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


@dataclasses.dataclass
class StepInputs:
    """A detached copy of what a train step reads from its TrainState."""

    step: int
    params: dict
    consts: dict
    alive: torch.Tensor


def copy_step_inputs(tstate) -> StepInputs:
    def copy(v):
        return [t.detach().clone() for t in v] if isinstance(v, list) else v.detach().clone()

    return StepInputs(
        step=tstate.step,
        params={k: copy(v) for k, v in tstate.params.items()},
        consts={k: copy(v) for k, v in tstate.consts.items()},
        alive=tstate.alive.clone(),
    )


def dump_debug_state(model_path: str, it: int, inputs: StepInputs, cam) -> str:
    """Dump a step's inputs (params, consts, alive mask, step count) and its
    camera matrices after a non-finite loss, to replay the step offline."""
    out = os.path.join(model_path, f"debug_dump_{it}.npz")
    flat = {"step": np.asarray(inputs.step)}
    for group in ("params", "consts"):
        for k, v in getattr(inputs, group).items():
            if isinstance(v, list):  # one tensor per mesh
                flat.update({f"{group}/{k}/{i}": t.cpu().numpy() for i, t in enumerate(v)})
            else:
                flat[f"{group}/{k}"] = v.cpu().numpy()
    flat["alive"] = inputs.alive.cpu().numpy()
    for attr in ("world_view", "full_proj", "cam_center"):
        flat[f"camera/{attr}"] = getattr(cam, attr).cpu().numpy()
    np.savez(out, **flat)
    return out


def gt_budget(device: torch.device) -> float:
    """Bytes of GT images that may live on `device`: a quarter of the card's
    free memory; no bound for the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] / 4
    return float("inf")


def place_gt(images: list[np.ndarray], device: torch.device,
             budget: float) -> tuple[list[torch.Tensor], bool]:
    """The GT images as tensors, and whether they are on `device`: there if
    their bytes fit `budget`, else on the host (pinned for a CUDA device),
    from where each step copies its image."""
    if sum(g.nbytes for g in images) <= budget:
        return [torch.as_tensor(g, device=device) for g in images], True
    host = [torch.as_tensor(g) for g in images]
    if device.type == "cuda":
        host = [t.pin_memory() for t in host]
    return host, False


def parse_profile_steps(spec: str | None) -> tuple[int, int] | None:
    """'START:STOP' -> (START, STOP), 1 <= START <= STOP; ValueError otherwise."""
    if spec is None:
        return None
    parts = spec.split(":")
    if len(parts) != 2:
        raise ValueError(f"--profile_steps takes START:STOP, got {spec!r}")
    lo, hi = int(parts[0]), int(parts[1])
    if not 1 <= lo <= hi:
        raise ValueError(f"--profile_steps needs 1 <= START <= STOP, got {spec!r}")
    return lo, hi


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
    p.add_argument("--detect_anomaly", action="store_true",
                   help="torch.autograd anomaly mode for the run and a loss check every "
                        "step; a non-finite loss dumps the step's inputs and raises")
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
    p.add_argument("--ip", default="127.0.0.1", help="network GUI host")
    p.add_argument("--port", type=int, default=0, help="network GUI port (0 disables)")
    p.add_argument("--profile_steps", default=None,
                   help="START:STOP: trace these steps into <model>/profile/trace.json "
                        "and their spans into spans.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def parallel_setup(args, device: torch.device, cleanup: contextlib.ExitStack):
    """(mode, mesh, rank, world) of the run: ("none", None, 0, 1) unless a
    sharding flag is given and the process is one of a job of several, whose
    process group it joins (and leaves when the run ends, if it started it)."""
    import torch.distributed as dist

    from ..parallel import create_mesh, multihost

    mode = "data" if args.data_parallel and args.shard == "none" else args.shard
    if mode == "none":
        return "none", None, 0, 1
    started = not multihost.is_initialized()
    if not multihost.initialize(backend="gloo" if device.type == "cpu" else None):
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            raise RuntimeError(
                f"--shard {mode} with {torch.cuda.device_count()} visible CUDA devices and no "
                "process group: launch one process per device, torchrun --nproc_per_node "
                "<devices> -m gaussian_mesh_splatting_tpu_torch.apps.train ...")
        return "none", None, 0, 1
    if started:
        cleanup.callback(dist.destroy_process_group)
    if dist.get_rank() == 0:
        print(f"joined a process group of {dist.get_world_size()} ({dist.get_backend()})")
    if dist.get_world_size() == 1:
        return "none", None, 0, 1
    return mode, create_mesh(), dist.get_rank(), dist.get_world_size()


def main(argv=None) -> TrainResult:
    args = build_parser().parse_args(argv)
    profile_range = parse_profile_steps(args.profile_steps)
    with contextlib.ExitStack() as cleanup:
        if args.detect_anomaly:
            # anomaly mode is global in the process: restored however the run ends
            cleanup.callback(torch.autograd.set_detect_anomaly, torch.is_anomaly_enabled())
            torch.autograd.set_detect_anomaly(True)
        return _train(args, profile_range, cleanup)


def _train(args, profile_range: tuple[int, int] | None,
           cleanup: contextlib.ExitStack) -> TrainResult:
    from ..device import resolve_device
    from ..io.checkpoint import restore_checkpoint, save_checkpoint, snapshot_dir
    from ..io.config_io import save_cfg
    from ..io.snapshots import save_snapshot
    from ..models import model_for
    from ..parallel import make_dp_train_step, make_sharded_train_step
    from ..parallel.multihost import check_replicas
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
    from ..utils.profiling import MetricsLogger, Recording, profiler_trace, tracing
    from .network_gui import NetworkGUI, image_to_bytes, parse_camera

    device = resolve_device(args.device)
    shard_mode, mesh, rank, world = parallel_setup(args, device, cleanup)
    if world > 1 and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())  # cuda:LOCAL_RANK
    main_rank = rank == 0
    say = print if main_rank else (lambda *a, **kw: None)
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
    if args.pair_capacity is not None and args.pair_capacity <= 0:
        raise ValueError("--pair_capacity must be positive")
    gui = None
    if args.port and main_rank:
        gui = NetworkGUI(args.ip, args.port)
        cleanup.callback(gui.close)
    # rank 0 alone serves the viewer: while the viewer pauses training, the
    # other ranks wait for it in a barrier of a gloo group of their own, not
    # in a collective of the job's group, whose timeout would end the job
    gui_group = None
    if args.port and world > 1:
        import torch.distributed as dist

        gui_group = dist.new_group(backend="gloo", timeout=VIEWER_PAUSE_LIMIT)

    scene = Scene(
        args.source_path, args.gs_type, model_path=args.model_path if main_rank else None,
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
        say(f"resumed from {args.start_checkpoint} at step {tstate.step} "
            f"({int(tstate.alive.sum())} alive of {tstate.alive.shape[0]} rows)")
    if main_rank:
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
        if shard_mode == "data":
            return make_dp_train_step(model, cfg, args.sh_degree, mesh, backend=args.backend,
                                      render_kwargs=rkw)
        if shard_mode in ("rows", "gaussians"):
            return make_sharded_train_step(model, cfg, args.sh_degree, mesh, shard=shard_mode,
                                           render_kwargs=rkw)
        return make_train_step(model, cfg, args.sh_degree, backend=args.backend,
                               render_kwargs=rkw)

    step_fn = build_step(pair_capacity)
    eval_fn = make_eval_render(model, args.sh_degree, backend=args.backend)

    bg_color = torch.full((3,), 1.0 if args.white_background else 0.0, device=device)
    rng = random.Random(args.seed)
    np_rng = np.random.default_rng(args.seed)
    densify_rng = torch.Generator(device=device).manual_seed(args.seed)
    gts, gt_on_device = place_gt([g for _, g in scene.train_cameras], device,
                                 gt_budget(device))
    if not gt_on_device:
        say(f"the {len(gts)} GT images exceed a quarter of the device's free memory: "
            "they stay in host memory and each step copies its image over")
    cams = [(c, g) for (c, _), g in zip(scene.train_cameras, gts)]
    order: list[int] = []
    if shard_mode != "none":
        say(f"{shard_mode}-parallel over {world} processes ({mesh.device_type} transport)")
    logger = MetricsLogger(args.model_path, tensorboard=True) if main_rank else None
    if args.save_xyz and main_rank:
        os.makedirs(os.path.join(args.model_path, "xyz"), exist_ok=True)

    losses: list[torch.Tensor] = []
    test_psnr: dict[int, float] = {}
    densify_events: list[dict] = []
    t_start = t_boundary = time.time()
    it_boundary = start_iter = tstate.step
    ema_loss = None
    profiling = cleanup.enter_context(contextlib.ExitStack())

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for it in range(start_iter + 1, cfg.iterations + 1):
        if args.save_xyz and main_rank and (it % 5000 == 1 or it == cfg.iterations):
            with torch.no_grad():
                xyz = model.to_bag(tstate.model_state()).xyz
            np.save(os.path.join(args.model_path, "xyz", f"{it}.npy"), xyz.cpu().numpy())
        if profile_range and main_rank and it == profile_range[0]:
            sync()
            profile_dir = os.path.join(args.model_path, "profile")
            profiling.enter_context(profiler_trace(profile_dir))
            spans = profiling.enter_context(tracing(Recording(device)))
        # GUI poll: while a viewer is connected, serve its frames; go on to
        # a train step once it asks for training (unchecking "train" in the
        # viewer pauses the optimization while the frames stay live)
        while gui is not None and gui.try_connect():
            try:
                msg = gui.receive()
                parsed = parse_camera(msg, device) if msg else None
                do_training = True
                img_bytes = None
                if parsed is not None:
                    gui_cam, do_training, _keep_alive, _scaling_modifier = parsed
                    img_bytes = image_to_bytes(eval_fn(tstate, gui_cam, bg_color).cpu().numpy())
                gui.send(img_bytes, args.source_path)
                if do_training:
                    break
            except ConnectionError:  # the viewer closed its connection
                gui.disconnect()
            except (OSError, ValueError, KeyError):  # a socket fault or a malformed request
                traceback.print_exc()
                gui.disconnect()
        if gui_group is not None:
            dist.barrier(group=gui_group)
        if it % 1000 == 0:
            one_up_sh_degree(tstate, args.sh_degree)
        if cfg.random_background:
            bg = torch.as_tensor(np_rng.random(3), dtype=torch.float32, device=device)
        else:
            bg = bg_color
        # the step's cameras: one, or under --shard data one a rank
        picked = []
        while len(picked) < (world if shard_mode == "data" else 1):
            if not order:
                order = list(range(len(cams)))
                rng.shuffle(order)
            picked.append(order.pop())
        cam, gt = cams[picked[rank if shard_mode == "data" else 0]]
        gt = gt.to(device, non_blocking=True)
        # the loss is read on the host after this step: keep its inputs for
        # the dump (the step updates the state in place)
        reads_loss = args.detect_anomaly or it == 1 or it % 100 == 0
        inputs = copy_step_inputs(tstate) if reads_loss else None
        try:
            tstate, metrics = step_fn(tstate, cam, gt, bg)
        except RuntimeError as e:  # anomaly mode raises inside the backward
            if not args.detect_anomaly:
                raise
            dump = dump_debug_state(args.model_path, it, inputs, cam) if main_rank else "rank 0"
            raise RuntimeError(f"train step {it} failed under --detect_anomaly; step inputs "
                               f"dumped to {dump}") from e
        losses.append(metrics["loss"])
        if args.detect_anomaly and not np.isfinite(float(metrics["loss"])):
            dump = dump_debug_state(args.model_path, it, inputs, cam) if main_rank else "rank 0"
            raise RuntimeError(f"non-finite loss at iteration {it}; step inputs dumped to {dump}")
        if profile_range and main_rank and it == profile_range[1]:
            sync()
            profiling.close()
            spans.write(os.path.join(profile_dir, "spans.json"))
            say(f"[it {it}] profiled steps {profile_range[0]}..{it} into {profile_dir}")

        if metrics["overflow"] > 0 and pair_capacity is not None:
            pair_capacity *= 2
            say(f"[it {it}] rasterizer pair overflow ({metrics['overflow']} pairs dropped): "
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
                    say(f"[it {it}] densify overflow: {info['overflow']} dropped")
                if not args.quiet and info["n_pruned"] > 0.5 * max(info["n_alive"], 1):
                    say(f"[it {it}] WARNING: densify pruned {info['n_pruned']} "
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
                say(f"[it {it}/{cfg.iterations}] loss {ema_loss:.5f} "
                    f"psnr {float(metrics['psnr']):.2f} iter {iter_ms:.1f}ms "
                    f"({time.time() - t_start:.0f}s)")
            if not np.isfinite(loss):
                dump = dump_debug_state(args.model_path, it, inputs, cam) if main_rank \
                    else "rank 0"
                raise RuntimeError(f"non-finite loss at iteration {it}; step inputs dumped to "
                                   f"{dump} (re-run with --detect_anomaly to catch the step "
                                   "that produced it)")
            if it % 100 == 0 and main_rank:
                logger.scalar("train_loss_patches/total_loss", loss, it)
                logger.scalar("train_loss_patches/l1_loss", float(metrics["l1"]), it)
                logger.scalar("iter_time", iter_ms, it)
                logger.scalar("rasterizer/pair_overflow", metrics["overflow"], it)
                logger.scalar("total_points", float(tstate.alive.sum()), it)

        if it in args.test_iterations and scene.test_cameras and main_rank:
            vals = []
            for idx, (tc, tgt) in enumerate(scene.test_cameras):
                img = eval_fn(tstate, tc, bg_color)
                vals.append(float(psnr(img, torch.as_tensor(tgt, device=device))))
                if idx < 5:
                    logger.image(f"test_view_{idx}/render", img.cpu().numpy(), it)
            test_psnr[it] = float(np.mean(vals))
            say(f"[it {it}] eval: test PSNR {test_psnr[it]:.2f}")
            logger.scalar("test/psnr", test_psnr[it], it)
            logger.histogram("scene/opacity_histogram",
                             torch.sigmoid(tstate.params["opacity"]).detach().cpu().numpy(), it)
            logger.flush()

        if it in args.save_iterations and main_rank:
            out_dir = snapshot_dir(args.model_path, it)
            save_snapshot(args.gs_type, model, tstate.model_state(), out_dir)
            say(f"[it {it}] saved snapshot to {out_dir}")

        if it in args.checkpoint_iterations and main_rank:
            save_checkpoint(checkpoint_path(args.model_path, it), tstate)
            say(f"[it {it}] checkpoint saved")

    if cfg.iterations not in args.save_iterations and main_rank:
        save_snapshot(args.gs_type, model, tstate.model_state(),
                      snapshot_dir(args.model_path, cfg.iterations))
    if world > 1:
        say(check_replicas(tstate, device))
    if logger is not None:
        logger.close()
    say(f"training done in {time.time() - t_start:.0f}s")
    return TrainResult(
        state=tstate,
        losses=torch.stack(losses).tolist() if losses else [],
        test_psnr=test_psnr,
        densify_events=densify_events,
    )


if __name__ == "__main__":
    main()

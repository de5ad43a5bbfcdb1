"""Readings for the limits of `correct`, on the card, at a cell's own size:
the program as configured ("exact"), the control ("bf16": the program's own
bfloat16 pair-table modes, the nearest precision below the configuration's
float32), or the program with a fault planted (`faults.FAULTS`: "unchanged",
"half", "answer", "densify_skipped", "split_unsampled"), over many seeds in
one process, each with a short window:

    python3 benchmark/control.py --workload gs_mesh.train --mode bf16 \\
        --seeds 11 12 13 --seconds 1 [--out build/benchmark/control.jsonl]

Prints one JSON line a seed: the numbers compared, beside the cell's limits.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(workload: str, mode: str, seeds, seconds: float, device: str = "cuda",
             root: str = ROOT):
    """Yield (seed, result, stderr lines) of a run of each seed in `mode`."""
    from benchmark import faults, harness

    kwargs = faults.PRECISION_CONTROL if mode == "bf16" else None
    for seed in seeds:
        broken = faults.FAULTS[mode]() if mode in faults.FAULTS else contextlib.nullcontext()
        with broken:
            result, lines = harness.run_cell(root, workload, seed, seconds, False, device,
                                             time.perf_counter(), render_kwargs=kwargs)
        yield seed, result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser("control")
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="exact",
                   choices=("exact", "bf16", "unchanged", "half", "answer", "densify_skipped",
                            "split_unsampled"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    out = open(args.out, "a") if args.out else None
    try:
        for seed, result, lines in readings(args.workload, args.mode, args.seeds, args.seconds):
            numbers = json.loads(next(l for l in lines if l.startswith("numbers "))[8:])
            diagnostics = json.loads(next(l for l in lines if l.startswith("diagnostics "))[12:])
            line = json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                               "correct": result["correct"], "numbers": numbers,
                               "diagnostics": diagnostics,
                               "limits": {k: v["limit"] for k, v in result["checks"].items()}})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

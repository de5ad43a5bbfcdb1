"""Run one cell of the benchmark of the PyTorch/CUDA port and print its
result as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine that holds the NVIDIA cards the
cell asks for; without them it exits 2 and prints no result. The numbers that
decide `correct` are printed beside their limits as the last lines of
standard error and, under "checks", last in the result.
"""
import os
import sys
import time

_T0 = time.perf_counter()
_BOOT = time.clock_gettime(time.CLOCK_BOOTTIME)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# torch's own kernel cache, inside the checkout (the port builds its kernels
# into build/kernels/ there)
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(ROOT, "build", "benchmark", "torch_kernels")
os.makedirs(os.environ["PYTORCH_KERNEL_CACHE_PATH"], exist_ok=True)
# one process with few threads: the timed path has no CPU tensor work
os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    torch.set_num_threads(1)

    started = harness.process_start_seconds()
    t_start = _T0 - (_BOOT - started) if started is not None else _T0
    chips = harness.load_cell(ROOT, args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda", t_start)
    found = harness.check_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

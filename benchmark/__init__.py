"""The benchmark of `gaussian_mesh_splatting_tpu_torch` (the PyTorch/CUDA
port): `python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout on a machine with an NVIDIA card.
See `harness.py` for how a cell is found and run."""

"""The parallel modes on `torch.distributed` (port of
`gaussian_mesh_splatting_tpu/parallel/`): one process per device, meshes of
process ranks, camera data parallelism, row- and Gaussian-sharded rendering
and training, and their composition on a 2-D mesh."""
from .mesh_setup import create_mesh, create_mesh2d, local_batch_slice
from .data_parallel import make_dp_train_step
from . import multihost
from .row_sharded import render_row_sharded
from .gaussian_sharded import render_gaussian_sharded
from .sharded_step import make_sharded_train_step

"""The port's `gs_mesh` model: the registry's module, as `apps/train` takes it."""
from gaussian_mesh_splatting_tpu_torch.models import mesh

OPTIMIZATION = "gs_mesh"  # the port's optimization settings of this kind


def model(scene):
    return mesh

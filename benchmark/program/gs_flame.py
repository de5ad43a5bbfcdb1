"""The port's `gs_flame` model: a `FlameGaussianModel` of the scene's rig,
with the configuration's counts of shape and expression parameters."""
import torch

from gaussian_mesh_splatting_tpu_torch.models.flame.decoder import FlameRig
from gaussian_mesh_splatting_tpu_torch.models.flame.lbs import LbsModel
from gaussian_mesh_splatting_tpu_torch.models.flame_gaussian import FlameGaussianModel

OPTIMIZATION = "gs_flame"  # the port's optimization settings of this kind


def model(scene):
    r = scene.rig
    lbs = LbsModel(v_template=r["v_template"], shapedirs=r["shapedirs"], posedirs=r["posedirs"],
                   j_regressor=r["j_regressor"],
                   parents=torch.tensor(r["parents"], device=r["v_template"].device),
                   lbs_weights=r["lbs_weights"], faces=scene.faces)
    return FlameGaussianModel(FlameRig(lbs, r["parents"]),
                              shape_dim=scene.params["flame_shape"].shape[1],
                              expr_dim=scene.params["flame_exp"].shape[1])

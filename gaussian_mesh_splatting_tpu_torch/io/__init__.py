from .obj import load_obj, save_obj
from .ply import (
    fetch_point_cloud,
    load_gaussians_ply,
    read_ply,
    save_gaussians_ply,
    store_point_cloud,
    write_ply,
)

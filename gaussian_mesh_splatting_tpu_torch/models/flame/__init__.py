from .decoder import (
    FlameRig,
    flame_forward,
    load_dynamic_landmarks,
    load_flame_pickle,
    load_static_landmarks,
    make_random_flame_like_rig,
    transform_flame_vertices,
)
from .lbs import LbsModel, batch_rodrigues, batch_rigid_transform, lbs

from .transforms import (
    build_scaling_rotation,
    covariance_from_scaling_rotation,
    inverse_sigmoid,
    quat_normalize,
    quat_to_rotmat,
    rotmat_to_quat,
    standardize_quaternion,
    strip_symmetric,
    unstrip_symmetric,
)
from .sh import C0, eval_sh, rgb_to_sh, sh_to_rgb
from .camera import (
    Camera,
    focal2fov,
    fov2focal,
    make_camera,
    projection_matrix,
    world_to_view,
)
from .face_frames import (
    FaceFrame,
    face_frames,
    face_scaling_rotation_quat,
    gaussians_to_pseudomesh,
    soup_frames,
    soup_scaling_rotation_quat,
)
from .lr_schedule import expon_lr, make_expon_lr_schedule

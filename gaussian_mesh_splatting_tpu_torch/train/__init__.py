from .config import (
    FlameOptimizationConfig,
    MeshOptimizationConfig,
    OPTIM_CONFIGS,
    OptimizationConfig,
    optimization_config,
)
from .densify import densify_and_prune, grow_capacity, reset_opacity
from .loop import make_eval_render, make_train_step, one_up_sh_degree, sh_degree_mask
from .loss import l1_loss, l2_loss, photometric_loss, psnr
from .state import (
    DensifyStats,
    TrainState,
    apply_lr_schedules,
    make_optimizer,
    make_train_state,
    optimizer_like,
)

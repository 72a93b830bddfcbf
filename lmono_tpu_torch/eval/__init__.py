from lmono_tpu_torch.eval.ate import (  # noqa: F401
    ate_rmse,
    rpe,
    umeyama_alignment,
    save_tum,
    load_tum,
)
from lmono_tpu_torch.eval.kitti_metrics import (  # noqa: F401
    kitti_odometry_errors,
    save_kitti_poses,
    load_kitti_poses,
)

from lmono_tpu_torch.estimator.estimator import (  # noqa: F401
    EstimatorState,
    FusionEstimator,
    FusionOutput,
    fusion_step,
)
from lmono_tpu_torch.estimator.initializer import HandEyeState  # noqa: F401
from lmono_tpu_torch.estimator.tracker import (  # noqa: F401
    FeatureTracker,
    TrackerState,
    TrackOutput,
    tracker_step,
)
from lmono_tpu_torch.estimator.window import (  # noqa: F401
    FeatureTable,
    MargPrior,
    WindowState,
)

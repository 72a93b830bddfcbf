from lmono_tpu_torch.estimator.tracker import (  # noqa: F401
    FeatureTracker,
    TrackerState,
    TrackOutput,
    tracker_step,
)

from lmono_tpu_torch.loop.detector import LoopDetector, LoopResult, detect_and_verify  # noqa: F401
from lmono_tpu_torch.loop.keyframe_db import KeyframeDB, db_add, db_query  # noqa: F401
from lmono_tpu_torch.loop.posegraph import (  # noqa: F401
    PoseGraph,
    graph_add_loop,
    graph_add_node,
    graph_poses,
    optimize_posegraph,
)

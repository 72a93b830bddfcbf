"""Host ms a traced window frame spends in pose-graph solves: the port's
`pose_graph.solve` spans, one per `SlamSystem._optimize` call of a reap
(0 on frames that solve nothing)."""

from slambench import spans

LAYER = "Pose graph (SlamSystem._reap_loops -> loop/posegraph.optimize_posegraph)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms_p90"
WORKLOADS = ["kitti00.revisit"]
CALLS = {"spans.pose_graph_solve": (spans.TARGET, spans.record)}


def read(view):
    return spans.per_frame(view["calls"].get("spans.pose_graph_solve"),
                           lambda r: spans.ms(r, "pose_graph.solve"))

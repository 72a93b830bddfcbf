"""The dense colored map's step (projection, completion, back-projection, voxel-hash merge), from the span around `MapBuilder.process`."""

LAYER = "Map merge (mapping/builder.MapBuilder.process)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti00.revisit"]
SPANS = {"map.host_ms_per_frame": ["lmono_tpu_torch.mapping.builder:MapBuilder.process"]}


def read(view):
    """Host ms per window frame inside the span (None: never entered)."""
    s = view["spans"].get("map.host_ms_per_frame")
    return None if s is None else 1e3 * s / view["frames"]

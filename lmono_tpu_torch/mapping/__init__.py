from lmono_tpu_torch.mapping.builder import (  # noqa: F401
    ColorMap,
    MapBuilder,
    build_frame,
    colormap_update,
    save_ply,
)
from lmono_tpu_torch.mapping.depth import (  # noqa: F401
    backproject_colored,
    complete_depth,
    project_cloud,
)

from lmono_tpu_torch.camera.base import CameraModel  # noqa: F401
from lmono_tpu_torch.camera.models import (  # noqa: F401
    pinhole_camera,
    pinhole_full_camera,
    mei_camera,
    equidistant_camera,
    scaramuzza_camera,
)
from lmono_tpu_torch.camera.factory import (  # noqa: F401
    camera_from_dict,
    camera_from_config,
    camera_from_yaml,
)
from lmono_tpu_torch.camera.calibration import (  # noqa: F401
    calibrate_camera,
    calibrate_pinhole,
    find_chessboard_corners,
)

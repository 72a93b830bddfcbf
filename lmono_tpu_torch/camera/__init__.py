from lmono_tpu_torch.camera.base import CameraModel  # noqa: F401
from lmono_tpu_torch.camera.factory import camera_from_config  # noqa: F401
from lmono_tpu_torch.camera.models import pinhole_camera  # noqa: F401

from lmono_tpu_torch.io.sync import MeasurementSync  # noqa: F401
from lmono_tpu_torch.io.replay import InputLog  # noqa: F401

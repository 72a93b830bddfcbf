"""lmono_tpu_torch — the LiDAR–monocular SLAM engine in PyTorch and CUDA.

A port of `lmono_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100, module by
module along the main path; `lmono_tpu` stays as the reference and this
package imports none of it.  Paths and names mirror the JAX package's
(`lmono_tpu/lidar/registration.py` → `lmono_tpu_torch/lidar/registration.py`).
Each TPU kernel becomes a hand-written Hopper kernel under `csrc/`, built
at first use; on CPU tensors the same functions run their plain PyTorch
versions.  Entry points run on the CUDA card unless the caller names
another device (`default_device`).
"""

import torch

# Everything is f32, as in the reference (x64 off).  TF32 keeps ~10 mantissa
# bits: the TPU's reduced-precision matmul put 10-70 m² of error into d² at
# world magnitudes, and the 6×6 normal equations need full f32 as well.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when one is given, else
    the CUDA card.  Raises when there is no card, so that nothing runs on
    the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


from lmono_tpu_torch.config import (  # noqa: E402,F401
    LidarConfig,
    SystemConfig,
    kitti_config,
    kitti_scale_config,
    synthetic_config,
)
from lmono_tpu_torch.utils.lie import Pose  # noqa: E402,F401

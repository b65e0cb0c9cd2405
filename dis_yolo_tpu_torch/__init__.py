"""dis_yolo_tpu_torch: PyTorch/CUDA port of DIS-YOLO (serving, training
and evaluation).

A second package beside the JAX reference ``dis_yolo_tpu``.  It imports
torch and numpy only, never JAX or the JAX package.  Plain tensor code is
PyTorch; the TPU's Pallas kernels on the serving path are hand-written
CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at first use.

Typical usage (on a CUDA card; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels on the CPU):

    from dis_yolo_tpu_torch import DISYoloConfig
    from dis_yolo_tpu_torch.models import api

    cfg = DISYoloConfig()
    model = api.init_model(cfg, seed=0)
    detections, masks = api.predict(model, images, windows)
"""

from dis_yolo_tpu_torch.config import DEFAULT_CONFIG, DISYoloConfig

__version__ = "0.1.0"
__all__ = ["DISYoloConfig", "DEFAULT_CONFIG", "__version__"]

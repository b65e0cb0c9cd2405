"""The plain float32 reference of the serving path of DIS-YOLO.

Plain PyTorch, float32, TF32 off (``plain_float32``), with no kernel,
batching trick or cache.  Frozen copies of the port's plain versions,
rewritten where the port's form serves speed; each departure is noted in
its module.  Nothing here imports ``dis_yolo_tpu_torch``, ``jax`` or the
JAX package: ``port_bench/tests/test_port_bench_isolation.py`` holds it
to that.
"""

import torch


def plain_float32() -> None:
    """Float32 matmuls and convolutions without TF32, as the reference
    computes them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

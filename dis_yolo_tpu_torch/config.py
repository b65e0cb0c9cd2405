"""Typed configuration for the PyTorch/CUDA port of DIS-YOLO.

A copy of ``dis_yolo_tpu/config.py`` (the port imports nothing of the JAX
package): the same frozen dataclass with the same field names, defaults
and properties, so the JAX reference and the port are built from the same
keyword arguments.  The comments describe what each knob means in the
port.  ``dp_axis`` names the data-parallel mesh's axis
(``parallel.sharding.make_mesh``); ``bn_axis``, as in JAX, names the axis
train-mode BatchNorm reduces over, which the port's mesh train step
always does over its mesh (``check_trainable``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DISYoloConfig:
    """All hyper-parameters of the DIS-YOLO instance-segmentation framework.

    Defaults reproduce the reference configuration (the reference's
    ``yolo/config.py``).
    """

    # ---- dataset / paths (host side only) -----------------------------------
    model_path: str = "."
    dataset: str = "data"
    output_dir: str = "output"
    weights_file: str = ""

    # ---- classes & anchors -------------------------------------------------
    classes: Tuple[str, ...] = ("crack", "spall", "rebar")
    # 9 anchors (w, h) in pixels from k-means at image size 576, as a flat
    # tuple so the dataclass stays hashable; use `anchors_array` for math
    anchors: Tuple[Tuple[float, float], ...] = (
        (31, 23), (62, 58), (143, 91), (213, 186), (61, 337),
        (194, 432), (474, 248), (551, 93), (478, 454),
    )
    anchors_per_scale: int = 3

    # ---- augmentation toggles (host loader, or device_side_augs) ----------
    flipped: bool = True
    blur_noise_light: bool = True

    # ---- training schedule (train/train_step.py) -----------------------------
    max_iter: int = 10000
    summary_iter: int = 50
    save_iter: int = 500
    lr_boundaries: tuple = (10000, 20000, 25000)
    lr_values: tuple = (1e-3, 1e-4, 1e-5, 1e-6)

    # ---- model ---------------------------------------------------------------
    alpha: float = 0.1              # leaky-ReLU slope
    batch_size: int = 2
    image_size: int = 576
    k_map: int = 3                  # k x k position-sensitive score maps
    mask_stride: int = 2            # score maps at input / mask_stride (1, 2, 4)

    # ---- loss scales (losses/) ----------------------------------------------
    object_scale: float = 2.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0
    mask_scale: float = 5.0
    score_scale: float = 2.0
    l2_scale: float = 1e-4
    ignore_thresh: float = 0.5

    # ---- detection thresholds -----------------------------------------------
    obj_threshold: float = 0.25     # strict: score > obj_threshold
    iou_threshold: float = 0.3      # NMS suppresses same-class IoU > this
    test_size: int = 576

    # ---- fixed-shape caps -----------------------------------------------------
    max_box_per_image: int = 20
    max_detection: int = 30
    # score-sorted candidates entering the O(K^2) greedy NMS; an underfilled
    # shortlist falls back to the exact full-candidate pass
    pre_nms_top_k: int = 512

    # ---- precision and kernels --------------------------------------------
    compute_dtype: str = "bfloat16"   # conv compute dtype; BN runs in f32
    param_dtype: str = "float32"
    # serving assembly: True runs kernel K1 on CUDA tensors (its plain
    # version on the CPU), exact 0 outside each box; False the JAX
    # package's gather formulation (sigmoid(0) = 0.5 outside the box on
    # valid rows).  `models/api.predict_from_outputs` and
    # `export.export_predict` read it.  The train step assembles through
    # K1/K3 either way: the gather computes the same logits
    use_pallas_assembly: bool = True
    # ---- serving graphs (inference only: `check_trainable` refuses them) ---
    # deploy: ConvBN blocks become conv + folded-BN bias + leaky
    # (models/layers.DeployConv; weights from models/fold.deploy_variables)
    deploy: bool = False
    # int8 post-training quantization (models/quant.py): the conv_bn layers
    # of `quant_layers` run s8 x s8 -> s32 with a float32 dequant epilogue;
    # weights from quant.quantize_deploy.  quant_calibrate builds the float
    # graph that records each such layer's input absmax and
    # `quant_calib_pct` percentile (quant.calibrate_deploy)
    quant: bool = False
    quant_calibrate: bool = False
    quant_layers: Tuple[int, ...] = tuple(range(5, 86))
    quant_calib_pct: float = 99.9
    # space-to-depth stem (deploy only, mask_stride != 1; models/s2d.py):
    # conv1 + conv2 rewritten exactly as 12->128 3x3 and 128->64 2x2 convs
    # at half resolution; weights from s2d.s2d_stem_variables
    s2d_stem: bool = False
    # ---- training knobs ----------------------------------------------------
    # flips and photometric augmentation inside the train step, on the
    # device (data/device_augment.py), instead of in the host loader
    device_side_augs: bool = False
    loader_workers: int = 0
    max_keep_ckpt: int = 0
    # recompute each ConvBN's conv/BN/activation in the backward instead of
    # keeping its activations (torch.utils.checkpoint)
    remat: bool = False
    # equal microbatches per step, gradients averaged (train_step.py)
    grad_accum: int = 1
    skip_nonfinite_updates: bool = True
    grad_clip_norm: float = 0.0
    # train steps per Solver block (train_step.make_multi_step)
    steps_per_dispatch: int = 1
    # the decoded split resident on the device; the host ships only the
    # placement decisions (data/device_corpus.py; needs device_side_augs)
    device_corpus: bool = False
    # decoder fusion nodes (layers 77/80/83) run their 1x1 conv before the
    # nearest upsample, the kernel split by rows (ignored by the deploy and
    # quant graphs, as in JAX)
    decoder_commute: bool = False
    # NMS through the hand-written CUDA kernel (ops/custom_ops.py) when the
    # tensors are on CUDA; otherwise, and by default, `nms_engine` runs
    use_pallas_nms: bool = False
    # "fixpoint": keep set by repeated O(K^2) sweeps until stable; "scan":
    # max_detection select-and-suppress rounds.  Both are exact greedy NMS.
    nms_engine: str = "fixpoint"
    # conv layer ids (1-based) frozen in training; stage 1 locks 1..52
    locked_layers: Tuple[int, ...] = tuple(range(1, 53))
    dp_axis: str = "dp"
    bn_axis: Optional[str] = None

    # -------------------------------------------------------------------------
    @property
    def num_class(self) -> int:
        return len(self.classes)

    @property
    def base_grid(self) -> int:
        # grid of the lowest-resolution (stride-32) head
        return self.image_size // 32

    @property
    def mask_size(self) -> int:
        # score-map side length
        return self.image_size // self.mask_stride

    @property
    def num_scoremaps(self) -> int:
        return self.k_map * self.k_map

    @property
    def output_depth(self) -> int:
        return (self.num_class + 5) * self.anchors_per_scale

    def anchors_array(self) -> np.ndarray:
        return np.asarray(self.anchors, dtype=np.float32)

    def class_to_ind(self) -> dict:
        return {c: i for i, c in enumerate(self.classes)}

    def grid_sizes(self) -> Tuple[int, int, int]:
        """Grid side lengths ordered small-object scale first (index 0 is
        the stride-8 map, as in the reference's ``interpret_output``)."""
        g = self.base_grid
        return (4 * g, 2 * g, g)

    def data_path(self, phase: str) -> str:
        return os.path.join(self.dataset, phase)

    def check_trainable(self, mesh=None) -> None:
        """Raise if the graph is one of the inference-only serving
        graphs.  ``device_corpus`` without ``device_side_augs`` is a
        ValueError (the host no longer holds the pixels to flip), and so
        is a ``bn_axis`` that is not the axis of the ``mesh`` trained on
        (sync-BN needs that mesh's step)."""
        for name, ported in UNPORTED_TRAIN_FIELDS.items():
            value = getattr(self, name)
            if value != ported:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported to dis_yolo_tpu_torch's "
                    f"train step yet (only {ported!r} is)")
        if self.bn_axis is not None and (
                mesh is None or mesh.axis_name != self.bn_axis):
            raise ValueError(
                f"bn_axis={self.bn_axis!r} needs a data-parallel mesh with "
                f"that axis to train on (got {mesh!r}): the mesh step "
                "synchronizes BatchNorm over its axis")
        if self.device_corpus and not self.device_side_augs:
            raise ValueError("device_corpus requires device_side_augs=True: "
                             "the host no longer holds pixels, so flips and "
                             "photometric run in the train step")

    def replace(self, **kw) -> "DISYoloConfig":
        return dataclasses.replace(self, **kw)

    def snapshot(self) -> str:
        """Human-readable config dump."""
        lines = []
        for f in dataclasses.fields(self):
            lines.append("{}: {}".format(f.name.upper(), getattr(self, f.name)))
        return "\n".join(lines) + "\n"


# the serving graphs, and the one value of each that the train step
# supports: they are inference only
UNPORTED_TRAIN_FIELDS = {"deploy": False, "quant": False,
                         "quant_calibrate": False, "s2d_stem": False}

DEFAULT_CONFIG = DISYoloConfig()

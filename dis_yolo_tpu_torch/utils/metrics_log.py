"""Training observability: JSONL metric stream + validation-history array
(a copy of ``dis_yolo_tpu/utils/metrics_log.py``).

Replaces the reference's tf.summary scalars (yolo3_net_pos.py:743-747,
train_yolo3_mask.py:35-36,212) and the 800x9 ``val_map`` ndarray dump
(train_yolo3_mask.py:120,181-183,227) with a plain JSONL event log plus an
equivalent validation-history ``.npy``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricLogger:
    def __init__(self, out_dir: str, run_name: str = "train"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{run_name}_metrics.jsonl")
        self._f = open(self.path, "a")
        # columns: step, epoch, loss, AP_crack, AP_spall, AP_rebar,
        #          recall, precision, mAP  (train_yolo3_mask.py:181-183)
        self.val_history = []

    def log(self, step: int, metrics: Dict[str, float], kind: str = "train"):
        rec = {"ts": time.time(), "step": int(step), "kind": kind}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_validation(self, step: int, epoch: int, loss: float, result: Dict):
        row = [step, epoch, loss, *result["AP"], result["recall"],
               result["precision"], result["mAP"]]
        self.val_history.append(row)
        self.log(step, {"epoch": epoch, "loss": loss, "mAP": result["mAP"],
                        **{f"AP_{i}": a for i, a in enumerate(result["AP"])}},
                 kind="val")

    def save_val_history(self, out_dir: str, step: int):
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, f"{step}map.npy"),
                np.asarray(self.val_history, np.float64))

    def close(self):
        self._f.close()

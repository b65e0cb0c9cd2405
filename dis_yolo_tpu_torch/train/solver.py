"""The training loop: the reference's ``Solver`` around the port's train step
(the counterpart of ``dis_yolo_tpu/train/solver.py``).

Loop structure, as the JAX package's:
  * the host loader (``data.dataset``, a prefetch thread or a pool of
    worker processes) feeds ``utils.runtime.device_prefetch``, which keeps
    two batches in flight to the card;
  * ``train_step.make_train_step`` takes each step (the piecewise
    learning rate inside the optimizer), the mask loss's ROI picks drawn
    from a ``torch.Generator`` seeded ``seed + 1``;
  * a metric row every ``summary_iter`` steps, with ``skipped_nonfinite``
    (the optimizer's ``total_notfinite``);
  * every ``save_iter`` steps: the validation sweep over the val split
    (``eval.sweep.run_split`` + ``Evaluator``), ``best.json``, a
    background checkpoint, pruning and the validation history ``.npy``;
  * the config written once to ``checkpoint/config.txt``.

Resume (``restore``, ``"auto"`` = the newest checkpoint) restores the
whole train state; ``weights_from`` is the stage bridge (weights only,
fresh optimizer and step); ``tf1_weights`` the stage-1 selective restore
from converted TF1 or darknet weights.

Not ported (``cfg.check_trainable`` refuses them): the K-steps-per-
dispatch blocks and the device corpus (``steps_per_dispatch``,
``device_corpus``, ``device_side_augs``), gradient accumulation and
sync-BN (``grad_accum``, ``bn_axis``); a ``mesh`` raises.  Everything
runs on ``cuda`` unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data.dataset import DefectTrainData, ParallelTrainData
from dis_yolo_tpu_torch.data.val_data import DefectValData
from dis_yolo_tpu_torch.eval.map_eval import Evaluator
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.train import checkpoint as ckpt
from dis_yolo_tpu_torch.train import train_step as ts
from dis_yolo_tpu_torch.utils.metrics_log import MetricLogger
from dis_yolo_tpu_torch.utils.runtime import device_prefetch
from dis_yolo_tpu_torch.utils.timer import Timer


class Solver:
    def __init__(self, cfg: DISYoloConfig,
                 data: Optional[DefectTrainData] = None,
                 evaluator: Optional[Evaluator] = None,
                 val_data: Optional[DefectValData] = None,
                 mesh=None, seed: int = 0,
                 restore: Optional[str] = None,
                 weights_from: Optional[str] = None,
                 tf1_weights: Optional[str] = None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "Solver(mesh=...): data-parallel training belongs to the "
                "port's parallel layer, not ported yet (ROADMAP A.7)")
        cfg.check_trainable()
        self.cfg = cfg
        self.device = api.resolve_device(device)
        if data is not None:
            self.data = data
        elif cfg.loader_workers:
            workers = None if cfg.loader_workers < 0 else cfg.loader_workers
            self.data = ParallelTrainData(cfg, "train", seed=seed,
                                          workers=workers)
        else:
            self.data = DefectTrainData(cfg, "train", seed=seed)
        self.evaluator = evaluator
        self.val_data = val_data
        self.ckpt_dir = os.path.join(cfg.output_dir, "checkpoint")
        self.loss_dir = os.path.join(cfg.output_dir, "lossnp")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(self.loss_dir, exist_ok=True)
        if ckpt.is_primary():
            with open(os.path.join(self.ckpt_dir, "config.txt"), "w") as f:
                f.write(cfg.snapshot())
        self.logger = MetricLogger(self.ckpt_dir)

        self.model = api.init_model(cfg, seed, device=self.device)
        if tf1_weights:      # stage-1 selective restore from TF1/darknet
            values = (np.load(tf1_weights, allow_pickle=True).item()
                      if tf1_weights.endswith(".npy")
                      else ckpt.convert_tf1_checkpoint(tf1_weights))
            self.model.load_state_dict(
                ckpt.stage1_restore(self.model.state_dict(), values))
        if weights_from:
            # stage transition: weights and BN statistics only; the
            # optimizer and the step start fresh (the trainable set
            # differs between stages)
            ckpt.restore_weights(weights_from, self.model)
        self.state = ts.init_train_state(self.model, device=self.device)
        if restore == "auto":
            restore = ckpt.latest_checkpoint(self.ckpt_dir)
            if restore:
                print(f"Auto-resuming from {restore}")
        if restore:
            ckpt.restore_checkpoint(restore, self.state)
        self.step_fn = ts.make_train_step(self.model, device=self.device)
        self.rng = torch.Generator().manual_seed(seed + 1)
        self._paste_cache: Dict = {}
        self.load_timer, self.train_timer = Timer(), Timer()
        best = ckpt.read_best(self.ckpt_dir)
        self.best_step = best["step"] if best else None
        self.best_map = best["mAP"] if best else -1.0

    # ------------------------------------------------------------------
    def validate(self, device_paste: Optional[bool] = None,
                 device_score: Optional[bool] = None) -> Optional[Dict]:
        """Validation sweep (``eval.sweep.run_split``), mAP only.

        The route is the one the JAX package takes on a GPU backend: the
        host route (raw masks fetched, pasted on the host) unless the
        caller asks for ``device_paste`` or ``device_score``.  On the card
        ``device_score`` is the fast one (PERF.md section 2: 14.35 against
        58 ms/image for the host route on an H100); the default stays the
        JAX package's.
        """
        if self.evaluator is None or self.val_data is None:
            return None
        from dis_yolo_tpu_torch.eval.sweep import run_split
        device_score = bool(device_score)
        device_paste = bool(device_paste) and not device_score
        # the split is read from disk once per Solver
        if not hasattr(self, "_val_arrays"):
            self._val_arrays = self.val_data.get()
        images, names, windows = self._val_arrays
        detdata, t_pred = run_split(
            self.cfg, self.model, images, names, windows,
            device_paste=device_paste, gt_sizes=self.evaluator.gt_sizes,
            paste_cache=self._paste_cache, want_semantic=False,
            device_score=device_score, gt_records=self.evaluator.gt_masks,
            device=self.device)
        result = self.evaluator.evaluate_detections(detdata)
        result["t_device_s"] = t_pred
        return result

    # ------------------------------------------------------------------
    def _at_save(self, step: int, start: int, max_iter: int,
                 record_loss: float):
        """Validate, mark the best, checkpoint in the background, prune,
        and write the validation history."""
        ckpt.check_background_saves()
        cfg = self.cfg
        result = self.validate()
        if result is not None:
            if result["mAP"] >= self.best_map:
                self.best_map, self.best_step = result["mAP"], step
                ckpt.mark_best(self.ckpt_dir, step, result["mAP"])
            if ckpt.is_primary():
                self.logger.log_validation(step, self.data.epoch,
                                           record_loss, result)
                done = step - start + 1
                print(f"Step {step} epoch {self.data.epoch} "
                      f"loss {record_loss:.3f} "
                      f"AP {['%.3f' % a for a in result['AP']]} "
                      f"mAP50 {result['mAP']:.3f} "
                      f"best {self.best_map:.3f}@{self.best_step} "
                      f"speed {self.train_timer.total_time / done:.3f}s/it "
                      f"load {self.load_timer.total_time / done:.3f}s/it "
                      f"remain {self.train_timer.remain(done, max_iter - start + 1)}")
        ckpt.save_checkpoint_background(self.ckpt_dir, self.state, step)
        protect = (step,) + ckpt.pending_steps() + (
            (self.best_step,) if self.best_step else ())
        ckpt.prune_checkpoints(self.ckpt_dir, cfg.max_keep_ckpt,
                               protect=protect)
        if ckpt.is_primary():
            self.logger.save_val_history(self.loss_dir, step)

    # ------------------------------------------------------------------
    def train(self, max_iter: Optional[int] = None):
        """Train from the state's step + 1 to ``max_iter`` (default
        ``cfg.max_iter``); returns the train state.  ``load_timer`` times
        the wait for each batch on the card, ``train_timer`` each step up
        to its metrics (the step synchronizes with the host there)."""
        cfg = self.cfg
        max_iter = max_iter or cfg.max_iter
        start = self.state.step + 1
        if start > max_iter:
            return self.state
        self.data.start_prefetch()
        try:
            batches = device_prefetch(
                (self.data.next_prefetched()
                 for _ in range(start, max_iter + 1)),
                size=2, device=self.device)
            epoch_loss, epoch_count = 0.0, 0
            for step in range(start, max_iter + 1):
                self.load_timer.tic()
                batch = next(batches)
                self.load_timer.toc()

                self.train_timer.tic()
                self.state, metrics = self.step_fn(self.state, batch, self.rng)
                self.train_timer.toc()
                # the loss stays on the device between syncs
                epoch_loss = epoch_loss + metrics["total_loss"]
                epoch_count += 1

                if step % cfg.summary_iter == 0 and ckpt.is_primary():
                    row = {k: float(v) for k, v in metrics.items()}
                    row["skipped_nonfinite"] = self.state.opt.total_notfinite
                    self.logger.log(step, row)

                if step % cfg.save_iter == 0:
                    self._at_save(step, start, max_iter,
                                  float(epoch_loss) / max(epoch_count, 1))
                    epoch_loss, epoch_count = 0.0, 0
        finally:
            self.data.stop()
        ckpt.wait_for_checkpoints()
        return self.state

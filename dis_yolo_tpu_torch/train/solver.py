"""The training loop: the reference's ``Solver`` around the port's train step
(the counterpart of ``dis_yolo_tpu/train/solver.py``).

Loop structure, as the JAX package's:
  * the host loader (``data.dataset``, a prefetch thread or a pool of
    worker processes) feeds ``utils.runtime.device_prefetch``, which keeps
    two batches in flight to the card;
  * ``train_step.make_multi_step`` takes each block of
    ``cfg.steps_per_dispatch`` steps (1 by default; the piecewise learning
    rate inside the optimizer), the mask loss's ROI picks drawn from a
    ``torch.Generator`` seeded ``seed + 1``;
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

With ``cfg.device_side_augs`` the loaders skip the host flips and
photometric (``host_augs=False``) and the step draws them from a second
generator on the device, seeded ``seed + 2``.  With
``cfg.device_corpus`` the split is uploaded once
(``data/device_corpus.py``) and each block assembles its batches on the
device (``train_step.make_corpus_multi_step``).  Everything runs on
``cuda`` unless ``device="cpu"`` is passed.

Data parallelism (``mesh``, a ``parallel.sharding.Mesh``; one Solver per
rank, on ``mesh.device``): ``cfg.batch_size`` is the global batch.  Each
rank's wire loader is a ``ParallelTrainData`` with ``host_shard=(rank,
size)`` (inline with ``loader_workers=0``), which builds only its rows
of each global batch; with ``device_corpus`` every rank holds the whole
corpus and the same decisions, and hands the step its rows.  The model
starts as rank 0's (broadcast after any restore), the steps are the mesh
steps (``train_step``), and validation sweeps each rank's share of the
split (``run_split(mesh=...)``).  Rank 0 alone logs, writes the config,
``best.json`` and the checkpoints (``train.checkpoint``); every rank
reads them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data.dataset import DefectTrainData, ParallelTrainData
from dis_yolo_tpu_torch.data.device_corpus import CorpusTrainData, upload_corpus
from dis_yolo_tpu_torch.data.val_data import DefectValData
from dis_yolo_tpu_torch.eval.map_eval import Evaluator
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.parallel.sharding import replicate
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
        cfg.check_trainable(mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.device = api.resolve_device(
            device if mesh is None else mesh.device)
        # with device-side augs the host loader must not flip or apply the
        # photometric augs too (they would apply twice)
        host_augs = not cfg.device_side_augs
        self.device_corpus = None
        if data is not None:
            self.data = data
        elif cfg.device_corpus:
            # the decoded split goes to the device once; the loader ships
            # the placement decisions only
            self.data = CorpusTrainData(cfg, "train", seed=seed)
        elif mesh is not None:
            workers = None if cfg.loader_workers < 0 else cfg.loader_workers
            self.data = ParallelTrainData(cfg, "train", seed=seed,
                                          host_augs=host_augs,
                                          workers=workers,
                                          host_shard=(mesh.rank, mesh.size))
        elif cfg.loader_workers:
            workers = None if cfg.loader_workers < 0 else cfg.loader_workers
            self.data = ParallelTrainData(cfg, "train", seed=seed,
                                          host_augs=host_augs,
                                          workers=workers)
        else:
            self.data = DefectTrainData(cfg, "train", seed=seed,
                                        host_augs=host_augs)
        if cfg.device_corpus:
            self.device_corpus = upload_corpus(self.data.corpus, self.device)
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
        self.state = ts.init_train_state(self.model, device=self.device,
                                         mesh=mesh)
        if restore == "auto":
            restore = ckpt.latest_checkpoint(self.ckpt_dir)
            if restore and ckpt.is_primary():
                print(f"Auto-resuming from {restore}")
        if restore:
            ckpt.restore_checkpoint(restore, self.state)
        if mesh is not None:
            replicate(mesh, self.model)
        if self.device_corpus is not None:
            corpus_fn = ts.make_corpus_multi_step(self.model,
                                                  device=self.device,
                                                  mesh=mesh)
            self.step_fn = lambda state, block, rng, aug_rng: corpus_fn(
                state, self.device_corpus, block, rng, aug_rng)
        else:
            self.step_fn = ts.make_multi_step(self.model, device=self.device,
                                              mesh=mesh)
        self.rng = torch.Generator().manual_seed(seed + 1)
        self.aug_rng = (torch.Generator(device=self.device).manual_seed(
            seed + 2) if cfg.device_side_augs else None)
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
            mesh=self.mesh, device=self.device)
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
        ``cfg.max_iter``) in blocks of K steps; returns the train state.

        K = ``cfg.steps_per_dispatch`` (1 by default), snapped down to a
        divisor of ``save_iter`` so that no block straddles a validation
        and checkpoint; the tail to ``max_iter`` may be a shorter block.
        Each block is ``self.step_fn`` (``train_step.make_multi_step``,
        or ``make_corpus_multi_step`` over the device corpus), equal to K
        single steps seed for seed.  The metrics stay stacked on the
        device until the block's end, where one fetch serves every
        ``summary_iter`` row inside it; ``skipped_nonfinite`` is the count
        at the block's tail.  ``load_timer`` times the wait for each block
        on the card, ``train_timer`` each block up to its metrics (the
        step synchronizes with the host there).
        """
        cfg = self.cfg
        max_iter = max_iter or cfg.max_iter
        start = self.state.step + 1
        if start > max_iter:
            return self.state
        k = max(1, cfg.steps_per_dispatch)
        while cfg.save_iter % k:
            k -= 1
        if k != cfg.steps_per_dispatch and ckpt.is_primary():
            print(f"steps_per_dispatch {cfg.steps_per_dispatch} -> {k} "
                  f"(snapped to a divisor of save_iter {cfg.save_iter})")

        # the corpus loader makes the global decisions: a rank takes its
        # rows (the wire loader of a mesh builds only those)
        local = self.mesh is not None and self.device_corpus is not None

        def blocks():
            todo = max_iter - start + 1
            while todo > 0:
                m = min(k, todo)
                bats = [self.data.next_prefetched() for _ in range(m)]
                todo -= m
                yield {key: np.stack([b[key][self.mesh.rows(len(b[key]))]
                                      if local else b[key] for b in bats])
                       for key in bats[0]}

        self.data.start_prefetch()
        try:
            batches = device_prefetch(blocks(), size=2, device=self.device)
            epoch_loss, epoch_count = 0.0, 0
            step = start - 1
            while step < max_iter:
                self.load_timer.tic()
                block = next(batches)
                self.load_timer.toc()
                self.train_timer.tic()
                self.state, metrics = self.step_fn(self.state, block,
                                                   self.rng, self.aug_rng)
                self.train_timer.toc()
                m = int(metrics["total_loss"].shape[0])
                first, step = step + 1, step + m
                # the loss stays on the device between syncs
                epoch_loss = epoch_loss + metrics["total_loss"].sum()
                epoch_count += m

                log_steps = [t for t in range(first, step + 1)
                             if t % cfg.summary_iter == 0]
                if log_steps and ckpt.is_primary():
                    rows = {key: v.cpu().numpy() for key, v in metrics.items()}
                    for t in log_steps:
                        row = {key: float(v[t - first])
                               for key, v in rows.items()}
                        row["skipped_nonfinite"] = \
                            self.state.opt.total_notfinite
                        self.logger.log(t, row)

                if step % cfg.save_iter == 0:
                    self._at_save(step, start, max_iter,
                                  float(epoch_loss) / max(epoch_count, 1))
                    epoch_loss, epoch_count = 0.0, 0
        finally:
            self.data.stop()
        ckpt.wait_for_checkpoints()
        return self.state

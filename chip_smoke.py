#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, evaluation and export
paths on one CUDA card and check them.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits non-zero before the last line is printed):

  1. device and build: the card's name, count and power limit; build the
     hand-written kernels of ``dis_yolo_tpu_torch/csrc`` with nvcc for
     sm_90a (one nvcc per source, all started together);
  2. each kernel against its plain PyTorch version, on the card, at the
     main paths' shapes: K1 (mask assembly) logits bit-exact and sigmoid
     within 1e-6 inside the box, exact 0 outside, at S=288 (B=2, D=30,
     padding rows), S=576 and k=5/7, and in all three modes (normalized
     boxes, pixel boxes, channel planes) and every swept launch shape at
     odd S=145 (k=3/5/7), S=576 and S=288 with boxes on the map's edges
     (x2 = S), 1-pixel, inverted and zero boxes; K2 (NMS) index-exact, by
     its default route and with the general route forced, at K=512, B=2,
     with mixed classes, forced score ties and overlapping boxes, at
     K=1024 and K=100, at K=1/31/33/1024 with B=3, on a knife edge of
     IoU within ulps of the threshold, with max_det above the valid
     count and max_det=1, on shuffled scores, with valid -inf scores, and
     with a valid NaN (nothing kept) and an invalid one (ignored); K3 (the
     assembly backward) bit-exact at S=288 (B=2, R=10, zero-box ROIs),
     S=576 (R=4) and k=5/7, and at the edges of its design: S=97 (rows
     off the 16-byte grid), k=1, k=16 (shared-memory accumulators), R=1,
     R=256 (MAX_ROIS), a ROI over the whole map and rows that meet no
     ROI; K1's pixel-box mode bit-exact on the same ROIs, and the
     training assembly's score-map gradient (K1 forward, K3 backward)
     within 1e-6 relative of autograd through the plain gather; K4
     (channel extraction) bit-exact for bf16 and f32 inputs at S=288 and
     S=576 (k=3, B=1 and B=2), S=64 (k=5, k=7), S=97, k=1, k=16, B=3 and
     on input views one element into their storage (off the 16-byte
     grid); K1 on channel planes bit-exact against K1 on the NHWC map,
     and ``assemble_masks_cuda`` with ``use_extract`` (K4 then K1)
     against its default route; K5 (the mask paste) against the dense
     route (cuBLAS's float32 products), exactly: masks, valid flags and
     semantic map at the four serving shapes (S=288/576, 720x960 and
     960x720, B=8, D=30) and with edge boxes (the map's edges, 1-pixel
     boxes, crops that round to nothing, class 255, an image of padding
     rows), with its device time beside its bound and the dense route's
     (``--out`` key ``k5_paste``);
  3. the serving slice: the full-width 576^2 model (Darknet-53, 3 heads,
     stride-2 decoder, bf16 compute, seeded random weights) through
     ``predict`` + ``paste_masks_batch`` at B=1 and B=2, with the
     defaults (K1) and with ``use_pallas_nms`` (K1+K2): identical
     outputs, 30 detections in image 0, launch counters > 0; then the
     float32 path (TF32 off) against the CPU forward and against the
     plain assembly on the same raw outputs;
     the training slice: ``make_train_step`` at 576^2, B=2, on a seeded
     synthetic batch in the loader's wire format (uint8 images, packed
     masks): three steps of stage 1 (layers 1-52 locked), then two of
     stage 2 (nothing locked) from stage 1's weights: finite metrics,
     locked layers bit-unchanged, every unlocked layer moved, K1 and K3
     launched; one step with ``use_pallas_nms`` gives the same metrics
     as without it; then one float32 step's loss and score-map gradient
     (TF32 off) against the CPU's;
     the serving graphs, from the same seeded weights: (a) the JAX
     package's bench graph (decoder_commute + fold_batchnorm), (b)
     deploy, (c) deploy + s2d_stem, (d) int8 (calibrated on the seeded
     batch, quantize_deploy, quant=True), each through ``predict`` +
     paste at B=1 and B=2 with its own calibrated threshold (30
     detections in image 0), and on each graph's score maps the
     ``use_extract`` route (K4 + K1, bf16 and f32 maps) equal to the
     default route and to predict's masks bit for bit; then at float32
     (TF32 off): (a) against the unfolded default graph, (b) against
     (a), (c) against (b), raw outputs within 1e-3 of max(1, max|ref|)
     and the same keep set, (d) against (b) within a normalized MAE of
     0.25 per output, and two int8 layers' int32 accumulators on the
     card equal to the CPU's;
     the evaluation path: a split of 7 seeded random images, 720x960 and
     960x720 with names interleaved (two tail batches at B=2),
     letterboxed by ``data.val_data.letterbox_image``; the seed-7 model
     with a threshold calibrated on it (``obj_threshold``), with and
     without ``use_pallas_nms``; ground truth from the host route's
     sweep (every second pasted detection, plus a rasterized triangle per
     image that nothing matches); ``eval.sweep.run_split``'s host,
     ``device_paste`` and ``device_score`` routes (with and without
     ``gt_semantic``) scored by ``Evaluator``: the same AP, mAP, recall
     and precision on every route and with K2, 0 < AP < 1 for a class,
     each ``device_score`` IoU row bit-equal to the host popcount over
     ``device_paste``'s fetched masks, the confusion totals equal to the
     host bincount over its fetched semantic maps, and a second
     ``device_score`` sweep on the same cache uploading nothing again and
     giving the same rows;
  4. timing with CUDA events: forward, predict and predict+paste ms at
     576^2 B=1 and B=2, and train-step ms at B=2 for both stages (stage 1
     also without the locked layers' gradients, with a profiler window of
     each for their device time); the eval sweep's s/image per route,
     device predict (the copies to the host included) and host post, the
     median of 3 sweeps after a warm one (``--out`` key ``eval_sweep``); each
     kernel and its plain version on the main paths' captured inputs, as
     device time per call from CUDA-graph replays (hot L2: the inputs
     were just written, as on the main path), beside its bound; one
     torch.profiler window of predict + paste at B=1 and one of a
     stage-2 train step, for the device's busy time, its idle share and
     the top kernels; predict and predict+paste ms of each serving graph
     at B=1 and B=2, one profiler window each of (b) and (d) at B=1, K4
     beside its bound and its one-call library equivalent
     (``copy_`` of the permuted view) for bf16 and f32 maps, the
     yardsticks of a one-element graph node and of a zero fill of K3's
     output, K1 in the planes layout, and the device memory a B=2
     predict+paste of (d) and of (b) takes; K2 with one round (its launch,
     loads and prologue) and the cost of each further round, by both
     routes; K1 in its three modes beside their bounds and a zero fill of
     its output, and each mode's launch shapes.

  The Solver (after the eval path in phase 3, timed in phase
  4): a seeded split of 8 train and 4 val images (720x960 and 960x720,
  concrete-like texture with darkened polygons, VIA labels over the 3
  classes) written as binary PPM under ``build/``, read with no OpenCV
  or PIL; ``dis_yolo_tpu_torch.cli.main`` in process three times:
  ``train --stage 1`` (6 steps at 576^2, B=2, a validation and a
  checkpoint every 3), ``train --stage 2 --weights-from`` stage 1's step
  6 (3 steps), and ``train --restore auto`` over run 1 to step 9.  It
  fails unless every logged loss is finite, layers 1-52 are bit-unchanged
  across stage 1, steps 3 and 6 are saved and ``best.json`` names one,
  the resumed state equals the step-6 checkpoint bit for bit (every
  tensor, Adam's count, the step), stage 2 starts from stage 1's weights
  with a fresh optimizer, validation mAP lies in [0, 1], and
  ``ParallelTrainData`` with 2 spawned workers gives the inline batches
  and stops within 10 s.  Phase 4 (``--out`` key
  ``solver_timing``): ``build_example`` ms per example,
  ``ParallelTrainData`` batches/s with 0, 2 and 4 workers, the Solver's
  wall, ``train_timer`` and ``load_timer`` s/step for both stages (and
  stage 1 fed by 4 loader processes), a profiler window of 5 Solver
  steps (idle share, launches, the largest gaps), the blocking ms of
  ``save_checkpoint_background``, and the device and idle ms of the
  forward's stage spans (``backbone``, ``heads``, ``mask_decoder``,
  ``utils/profiling.py``) in one profiled window of full forwards at
  B=1 (``port_bench.program_trace``).

  Device-data training (after the Solver in phase 3, timed in phase 4):
  on the card at 576^2, B=2, ``device_augment.augment_batch`` against
  the CPU on the same draws with every flip and photometric branch
  forced (flips, masks, boxes, grids exact, images within 1 LSB); the
  Solver's train split decoded into a ``HostCorpus`` and uploaded
  (``--out`` key ``device_data``, ``corpus``: bytes, build and upload
  s); ``make_assemble_fn`` on the card against the CPU (exact grids and
  boxes, images within 1 LSB) and against ``build_example(host_augs=
  False)`` (masks but for knife edges); no host sync in assembly,
  ``prepare_batch``, ``draw_augment`` and ``augment_batch`` (PyTorch's
  sync debug mode, key ``host_syncs_assemble_augment``); a K=3 stage-1
  block through
  ``make_corpus_multi_step`` against three single steps under
  deterministic algorithms (bit-equal); a float32 ``grad_accum=2``
  step against the CPU's (metrics, the score-map head's gradient, BN
  statistics); a stage-2 step with ``remat`` against one without (the
  same metrics and statistics, each step's peak memory); then ``cli
  train --device-corpus --steps-per-dispatch 3`` stage 1 for 6 steps (a
  checkpoint every 3) and a resume to step 9 (launch path
  ``device_data``).  Phase 4 (``device_data_timing``): the Solver's
  wall, ``train_timer`` and ``load_timer`` per step (30 steps, two
  passes) and the bytes sent to the card per step for the wire loader
  at K=1 and K=3 and the corpus at K=3; the device time of the corpus
  step's data work by part (assembly, its image and mask placement and
  grids, ``prepare_batch``, ``augment_batch``); remat and plain stage-2
  steps timed under the default cuDNN and TF32 settings.

  Data parallelism (after the device-data phase; ``--out`` key
  ``parallel``, launch path ``parallel``): the ranks run in worker
  processes (``chip_smoke.py --dp-worker SPEC``), each joining its group
  through ``parallel.distributed.initialize``.  (a) Two ranks on this
  card over gloo, global batch 4 (2 rows each) at 576^2: 3 float32
  stage-2 steps (TF32 off) against 3 one-process steps on the same
  global batches and draws (step-1 loss within rel 1e-4, parameters
  within rtol 5e-2, atol 3e-3), the ranks' parameters, BN statistics
  and Adam moments bit-equal, K1 and K3 launched in each rank; then 3
  bf16 steps of the default config, finite and bit-equal across ranks;
  each step's wall and the packed all-reduce alone at the step's size
  (gloo on one card: through host memory).  (b) World size 1 over
  NCCL in this process: 2 mesh steps bit-equal to the steps without a
  mesh (deterministic algorithms).  (c) Two NCCL ranks, a card each,
  as (a) when there are two cards; else it says it skipped.  (d) The
  DP sweep of the Solver split's val images by the host and
  device_score routes on (a)'s ranks: the keep sets, boxes and mAP of
  the one-process sweep at a rank's batch (the same images in each
  batch).  (e) ``cli train --data-parallel`` under
  ``torch.distributed.run``, two ranks on this card: 2 steps, a
  validation and rank 0's checkpoint.  (f) Spatial partitioning: after
  (d), (a)'s two ranks form a 1-D ``sp = 2`` mesh and split the height
  (``parallel.spatial``) at 576^2, full width: ``spatial_predict`` of
  one val image in float32 (the one-process keep set row for row,
  classes equal, boxes and scores within rtol 1e-5) and in bf16 (the
  kept count within 2), then 3 float32 stage-2 ``spatial_train_step``
  steps at B=2 (step-1 loss within rel 1e-4 of one process, replicas
  bit-equal), K1 and K3 launched in each rank; recorded per rank:
  predict ms, step s, the bytes each rank puts into the halo exchanges
  and gathers of one predict, and peak device memory beside one
  process's.  Also the default int8 graph (layers 5-85, absmax
  calibration in one process, its own threshold): its spatial predict
  (the kept count within 2 of one process, the top 5 scores within rtol
  1e-2, K1 launched in each rank; ms and bytes per rank; ``--out`` key
  ``parallel.int8_predict``) and the int32 accumulator rows of its
  layers 5 and 7 on each rank, given one process's input, equal to one
  process's to the bit; and the float32 stage-2 steps again with
  ``remat``, both runs under deterministic algorithms: every metric and
  the state equal to the plain spatial step's to the bit, the peak per
  rank below it, K3 launched in each rank (``parallel.remat_step``:
  s per step and peak memory per rank, with and without).

  The serving export (after the Solver in phase 3, timed in phase 4):
  the deploy graph exported (``export.export_predict``) at B=1 and at a
  dynamic batch, the deploy graph with ``use_pallas_nms`` at B=1 and
  the int8 graph at B=1, at 576^2 from the seed-7 weights, each saved
  and loaded back in a fresh process (``chip_smoke.py --artifact-worker
  SPEC``) that imports torch and ``export.load_artifact`` only, with
  K1's and K2's plain versions replaced by stubs that raise; it fails
  unless no module of the model code was imported there, each call
  launched K1 once (and K2 once where it is on), and each output (B=1,
  2, 3 for the dynamic batch) matches the live predict of the same
  graph (class column equal, detections within rtol 1e-5 / atol 1e-6,
  masks within atol 5e-4).  Then ``python -m dis_yolo_tpu_torch.cli``
  on the Solver's val images: ``infer`` with the Solver's step-6
  checkpoint, ``infer`` with a checkpoint of the seed-7 weights
  against ``infer --artifact`` of its ``export --symbolic-batch``, at a
  threshold where their two graphs agree here (the same detection count
  per image, each equal to its graph's here), and ``verify-gt``; every
  overlay is a PNG of its image's size.  Phase 4 (``--out`` key
  ``export_timing``): export s and artifact MB per artifact, the
  loaded artifacts' predict ms at B=1 and B=2 (CUDA events, in a fresh
  process, with a profiler window of the host's operators at B=1)
  beside the live predict of the same graph; the deploy artifact at B=1
  also loaded in the main process, and its program as ``torch.export``
  leaves it (with the assert nodes the export drops), alternating with
  the live predict, each with a profiler window of its host operators;
  and
  ``infer`` ms per image end to end (host clock) over 20 images, the val
  images copied 5 times, by the checkpoint and the artifact routes.

Phase 1 prints, and ``--out`` keeps under ``ptxas``, each kernel's
registers and spill bytes from its ``nvcc -Xptxas -v`` log; the run fails
at its end if K1 or K2 has a stack frame or spills.  K2's forced general
route and K1's launch shapes go through the C entry points
``dis_nms_config`` and ``dis_assemble_masks_config``, which count no
launch; ``--out`` keeps the sweeps under ``k2_sweep`` and
``k1_modes_and_sweep``.

The last lines are the card's ``nvidia-smi`` name and power limit, one
``{"kernels": [...]}`` JSON line and ``{"ok": true, "device": {...}}``.
Each kernel's ``launches`` is the sum over the serving path, the
training path, the serving graphs' path, the eval path, the Solver's
path, the device-data path (the ``--device-corpus`` command), the
data-parallel path (the two gloo ranks' training runs and their spatial
predicts and steps, counted in their processes) and the export path (its live predicts here and the loaded
artifacts' calls in their process), and ``launches_by_path``
holds each path's own count (each read from its run, with the counters
set to 0 just before it).  Only K4 has a single PyTorch call computing
the same function (``torch.empty(k*k,S,S).copy_(sm.permute(2,0,1))``);
``library_ms`` is null for the others.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

# published peaks of one H100 SXM (NVIDIA data sheet), at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations of one IoU > thr pair test with precomputed areas:
# 4 max/min, 2 sub, 2 clamp, 1 mul (inter), add+sub (union), 2 compares,
# 1 div, 1 class compare
NMS_OPS_PER_PAIR = 15


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def need(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, n: int, warmup: int = 3, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean ms per call of ``fn`` over ``n``
    calls, CUDA events (host overhead included: the path syncs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop) / n)
    return sorted(runs)[len(runs) // 2]


def graph_ms(torch, fn, n: int = 20, reps: int = 10) -> float:
    """Device ms per call of ``fn``: ``n`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's launch
    overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (n * reps)


@contextlib.contextmanager
def capturing(captured: dict, *targets):
    """Record the last arguments of each ``(module, name)`` function called
    inside the block; the originals are back in place on the way out."""
    saved = [(module, name, getattr(module, name)) for module, name in targets]
    for module, name, fn in saved:
        # wraps copies the launch counter: a wrapped kernel's own body
        # counts on the module global, which is the wrapper meanwhile
        @functools.wraps(fn)
        def wrapper(*a, _fn=fn, _name=name, **kw):
            captured[_name] = (a, kw)
            return _fn(*a, **kw)
        setattr(module, name, wrapper)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def kernel_kind(name: str) -> str:
    """Coarse class of a device kernel, from its name."""
    n = name.lower()
    for kind, keys in (("K3 assembly backward", ("assembly_bwd_kernel",)),
                       ("K1 assembly", ("assembly_kernel",)),
                       ("K2 nms", ("nms_kernel",)),
                       ("K4 extract", ("extract_kernel",)),
                       ("int8 gemm", ("gemm_s8", "imma", "s8s8", "i8i8")),
                       ("cat (concat, im2col)", ("catarraybatchedcopy",)),
                       ("batchnorm", ("bn_fw",)),
                       ("conv/gemm", ("xmma", "conv", "gemm", "cutlass")),
                       ("elementwise", ("elementwise",)),
                       ("reduce/sort/scan", ("reduce", "sort", "radix", "scan"))):
        if any(k in n for k in keys):
            return kind
    return "other"


def kernel_launches(profiling, *kernels) -> dict:
    """Launches so far of ``kernels`` ("K1" .. "K5"; all five by default),
    from the port's ``kernel.k*`` counters."""
    c = profiling.counters()
    return {k: c.get(f"kernel.k{k[1:]}", 0)
            for k in kernels or ("K1", "K2", "K3", "K4", "K5")}


def ptxas_usage(log: str) -> dict:
    """Registers, stack frame and spill bytes and static shared memory per
    kernel entry (mangled name) from an ``nvcc -Xptxas -v`` log."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = {}
        elif fn is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                usage[fn].update(stack_frame=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                usage[fn]["static_smem_bytes"] = int(m.group(1))
    return usage


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_boxes(torch, gen, b, d, n_pad):
    """[b,d,4] normalized yxyx boxes, the last ``n_pad`` rows zero; the
    first four rows start on .5 pixel ties of S=288 (rounding knife edge)."""
    u = torch.rand((b, d, 4), generator=gen)
    y1, y2 = torch.minimum(u[..., 0], u[..., 2]), torch.maximum(u[..., 0], u[..., 2])
    x1, x2 = torch.minimum(u[..., 1], u[..., 3]), torch.maximum(u[..., 1], u[..., 3])
    boxes = torch.stack([y1, x1, y2, x2], -1)
    ties = (torch.randint(0, 200, (b, 4, 2), generator=gen).float() + 0.5) / 288
    ext = (torch.randint(10, 80, (b, 4, 2), generator=gen).float() + 0.5) / 288
    boxes[:, :4] = torch.cat([ties, ties + ext], -1)
    boxes[:, d - n_pad:] = 0.0
    return boxes


def check_assembly(torch, custom_ops, gen, b, s, k, d, n_pad):
    """K1 vs its plain version on the card; returns max |diff| of probs."""
    sm = torch.randn((b, s, s, k * k), generator=gen).cuda()
    bx = random_boxes(torch, gen, b, d, n_pad).cuda()
    got = custom_ops.assemble_masks_batch_cuda(sm, bx, k, apply_sigmoid=False)
    want = custom_ops.assemble_masks_batch_plain(sm, bx, k, apply_sigmoid=False)
    torch.cuda.synchronize()
    need(torch.equal(got, want), f"K1 logits not bit-exact (S={s} k={k})")
    # the plain version on the card against the plain version on the CPU
    need(torch.equal(want.cpu(), custom_ops.assemble_masks_batch_plain(
        sm.cpu(), bx.cpu(), k, apply_sigmoid=False)),
        f"K1 plain logits differ between card and CPU (S={s} k={k})")
    got = custom_ops.assemble_masks_batch_cuda(sm, bx, k)
    want = custom_ops.assemble_masks_batch_plain(sm, bx, k)
    torch.cuda.synchronize()
    inside = want != 0
    need(torch.equal(got != 0, inside), f"K1 support differs (S={s} k={k})")
    need(bool(inside.any()), "K1 case has no pixel inside a box")
    need(not bool(got[:, d - n_pad:].any()), "K1 padding rows not zero")
    err = float((got - want).abs().max())
    need(err <= 1e-6, f"K1 sigmoid error {err} > 1e-6 (S={s} k={k})")
    print(f"K1 S={s} B={b} D={d} k={k}: logits bit-exact, sigmoid max err "
          f"{err:.3g}", flush=True)
    return err


def random_px_boxes(torch, gen, b, r, s, n_zero):
    """[b,r,4] rounded yxyx score-map pixel boxes (ROIs), the last
    ``n_zero`` zero (padded proposals) and the first inverted (empty)."""
    u = torch.rand((b, r, 4), generator=gen)
    y1, y2 = torch.minimum(u[..., 0], u[..., 2]), torch.maximum(u[..., 0], u[..., 2])
    x1, x2 = torch.minimum(u[..., 1], u[..., 3]), torch.maximum(u[..., 1], u[..., 3])
    boxes = torch.round(torch.stack([y1, x1, y2, x2], -1) * s)
    boxes[:, 0] = boxes[:, 0, [2, 1, 0, 3]]
    boxes[:, r - n_zero:] = 0.0
    return boxes


def edited_px_boxes(torch, gen, b, r, s, edit):
    """``random_px_boxes`` with no zero boxes, edited: "upright" undoes the
    first ROI's inversion, "full" makes ROI 1 the whole map, "top" keeps
    every ROI in the top half of the rows (the rows below meet no ROI)."""
    boxes = random_px_boxes(torch, gen, b, r, s, 0)
    if edit == "upright":
        boxes[:, 0] = boxes[:, 0, [2, 1, 0, 3]]
    elif edit == "full":
        boxes[:, 1] = torch.tensor([0.0, 0.0, s, s])
    elif edit == "top":
        boxes[..., 0::2] = torch.floor(boxes[..., 0::2] / 2)
    return boxes


def check_assembly_bwd(torch, cuda_assembly, custom_ops, mask_assembly, gen, b, s,
                       k, r, n_zero, check_grad, edit=None):
    """K3 bit-exact against its plain version, K1's pixel-box mode
    bit-exact, and (``check_grad``) the training assembly's score-map
    gradient against autograd through the plain gather.  The ROIs are
    ``random_px_boxes`` or, with ``edit``, ``edited_px_boxes``.  Returns
    K3's max |diff| and the gradient's error relative to max |ref|."""
    boxes = (random_px_boxes(torch, gen, b, r, s, n_zero) if edit is None
             else edited_px_boxes(torch, gen, b, r, s, edit)).cuda()
    g = torch.randn((b, r, s, s), generator=gen).cuda()
    got = cuda_assembly.assemble_bwd_cuda(boxes, g, k)
    want = mask_assembly.assemble_bwd_plain(boxes, g, k)
    torch.cuda.synchronize()
    tag = f"S={s} k={k} R={r}" + (f" {edit}" if edit else "")
    need(torch.equal(got, want), f"K3 not bit-exact ({tag})")
    need(torch.equal(want.cpu(), mask_assembly.assemble_bwd_plain(
        boxes.cpu(), g.cpu(), k)), f"K3 plain differs card vs CPU ({tag})")
    need(bool(got.any()), f"K3 case has no pixel inside a ROI ({tag})")
    if edit == "top":
        need(not bool(got[:, s // 2:].any()), f"K3 rows below every ROI not zero ({tag})")
    sm = torch.randn((b, s, s, k * k), generator=gen).cuda()
    fwd = custom_ops.assemble_masks_batch_cuda(sm, boxes, k, apply_sigmoid=False,
                                                  pixel_boxes=True)
    need(torch.equal(fwd, custom_ops.assemble_masks_batch_plain(
        sm, boxes, k, apply_sigmoid=False, pixel_boxes=True)),
        f"K1 pixel-box logits not bit-exact ({tag})")
    rel = 0.0
    if check_grad:
        sm_k = sm.clone().requires_grad_(True)
        (cuda_assembly.assemble_masks_trainable(sm_k, boxes, k) * g).sum().backward()
        sm_p = sm.clone().requires_grad_(True)
        (mask_assembly._assemble_px(sm_p, boxes, k)[0] * g).sum().backward()
        torch.cuda.synchronize()
        rel = float((sm_k.grad - sm_p.grad).abs().max() / sm_p.grad.abs().max())
        # the gather's backward scatters into an expanded [B,R,S,S,k^2]
        # tensor and sums over R in its own order; K3 adds in ROI order
        need(rel <= 1e-6, f"training assembly grad vs plain gather: rel err {rel}")
    print(f"K3 B={b} {tag}: bit-exact; K1 pixel-box bit-exact"
          + (f"; grad vs plain gather rel err {rel:.3g}" if check_grad else ""),
          flush=True)
    return float((got - want).abs().max()), rel


def check_extract(torch, cuda_assembly, gen, b, s, k, dtype, offset=0):
    """K4 bit-exact against its plain version on the card, and the plain
    version on the card against the CPU's.  ``offset``: the input is a
    contiguous view that many elements into its storage (a pointer off the
    16-byte grid)."""
    n = b * s * s * k * k
    base = torch.randn((n + offset,), generator=gen).to(dtype).cuda()
    sm2d = base[offset:].view(b, s, s * k * k)
    tag = f"S={s} k={k} B={b} {str(dtype)[6:]}" + (f" offset {offset}" if offset else "")
    need(sm2d.is_contiguous() and (sm2d.data_ptr() % 16 != 0) == (offset > 0),
         f"K4 case input alignment ({tag})")
    got = cuda_assembly.extract_planes_cuda(sm2d, k)
    want = cuda_assembly.extract_planes_plain(sm2d, k)
    torch.cuda.synchronize()
    need(got.dtype == torch.float32 and torch.equal(got, want),
         f"K4 not bit-exact ({tag})")
    need(torch.equal(want.cpu(), cuda_assembly.extract_planes_plain(
        sm2d.cpu(), k)), f"K4 plain differs card vs CPU ({tag})")
    print(f"K4 {tag}: bit-exact", flush=True)
    return float((got - want).abs().max())


def check_planes(torch, cuda_assembly, custom_ops, gen, b, s, k, d, n_pad):
    """K1 on channel planes [B,k*k,S,S] equals K1 on the NHWC map bit for
    bit (logits and sigmoid), and the single-image ``use_extract`` route
    (K4 + K1 planes) equals the default route on bf16 and f32 maps."""
    sm = torch.randn((b, s, s, k * k), generator=gen).cuda()
    bx = random_boxes(torch, gen, b, d, n_pad).cuda()
    planes = sm.permute(0, 3, 1, 2).contiguous()
    for sig in (False, True):
        got = custom_ops.assemble_masks_batch_cuda(planes, bx, k, sig,
                                                      planes=True)
        want = custom_ops.assemble_masks_batch_cuda(sm, bx, k, sig)
        need(torch.equal(got, want), f"K1 planes != NHWC (S={s} k={k})")
    for dtype in (torch.bfloat16, torch.float32):
        one = sm[0].to(dtype)
        ext = cuda_assembly.assemble_masks_cuda(one, bx[0], k, use_extract=True)
        dflt = cuda_assembly.assemble_masks_cuda(one, bx[0], k)
        need(torch.equal(ext, dflt), f"use_extract route != default "
             f"(S={s} k={k} {dtype})")
    torch.cuda.synchronize()
    print(f"K1 planes S={s} B={b} k={k}: bit-exact against NHWC; "
          f"use_extract route equal (bf16, f32)", flush=True)


GRAPH_NAMES = {"a": "decoder_commute + fold_batchnorm (bench.py's graph)",
               "b": "deploy", "c": "deploy + s2d_stem",
               "d": "int8 (quant, absmax calibration)"}


def build_graphs(api, fold, quant, s2d, cfg, sd, calib_images):
    """The four serving graphs from one ConvBN state_dict: (a) the JAX
    package's bench graph, decoder_commute on fold_batchnorm's weights;
    (b) deploy; (c) deploy + s2d_stem; (d) int8, calibrated (absmax) on
    ``calib_images``, then quantize_deploy.  Returns {key: (cfg, model)}
    and the calibration dict."""
    dsd = fold.deploy_variables(sd)
    trees = {"a": (cfg.replace(decoder_commute=True), fold.fold_batchnorm(sd)),
             "b": (cfg.replace(deploy=True), dsd),
             "c": (cfg.replace(deploy=True, s2d_stem=True),
                   s2d.s2d_stem_variables(dsd))}
    absmax = quant.calibrate_deploy(
        api.create_model(cfg.replace(quant=True, quant_calibrate=True)),
        dsd, calib_images)
    trees["d"] = (cfg.replace(quant=True), quant.quantize_deploy(dsd, absmax))
    graphs = {}
    for key, (gcfg, gsd) in trees.items():
        graphs[key] = (gcfg, api.create_model(gcfg))
        graphs[key][1].load_state_dict(gsd)
    return graphs, absmax


def rel_err(got, want):
    """max |got - want| / max(1, max |want|)."""
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def norm_mae(got, want):
    """mean |got - want| / (mean |want| + 1e-6), in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().mean() / (want.abs().mean() + 1e-6))


def profile_window(torch, fn, calls, wall_ms, host_ops=False):
    """One torch.profiler window of ``calls`` calls of ``fn``: device busy
    time per call, its idle share against ``wall_ms`` (the unprofiled
    time per call) and the top kernels; with ``host_ops`` also the host's
    operator calls per call, their summed self time and the ops with the
    most self time (what the host spends between the device's kernels)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / calls
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device) / calls
    by_kind, top = {}, {}
    for e in device:
        kind_ = kernel_kind(e.key)
        by_kind[kind_] = by_kind.get(kind_, 0.0) + e.self_device_time_total / calls
        top[e.key[:100]] = top.get(e.key[:100], 0.0) + e.self_device_time_total / calls
    host = {}
    if host_ops:
        cpu = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU]
        cpu.sort(key=lambda e: -e.self_cpu_time_total)
        host = {"host_op_calls_per_call": sum(e.count for e in cpu) / calls,
                "host_self_us_per_call": sum(e.self_cpu_time_total
                                             for e in cpu) / calls,
                "top_host_ops_us_and_calls_per_call": {
                    e.key[:80]: [e.self_cpu_time_total / calls, e.count / calls]
                    for e in cpu[:12]}}
    return {**host, "wall_us_per_call_profiled": wall_us,
            "device_busy_us_per_call": busy_us if device else "not measured",
            # the profiler slows the host, so the idle share is taken
            # against the unprofiled time of phase 4
            "device_idle_share": (1 - busy_us / (wall_ms * 1e3)
                                  if device else "not measured"),
            "kernel_launches_per_call": sum(e.count for e in device) / calls,
            "device_us_by_kind": by_kind,
            "top_kernels_us_per_call": dict(sorted(top.items(),
                                                   key=lambda kv: -kv[1])[:10])}


def state_moved(before, after, keys):
    """Keys (params and BN statistics) whose tensors changed."""
    return {k for k in keys if not before[k].equal(after[k])}


# the eval split: 7 images, landscape and portrait (h, w), names
# interleaved; at B=2 each size group ends in a tail batch
EVAL_SIZES = ((720, 960), (960, 720))
EVAL_GROUPS = (0, 1, 0, 0, 1, 1, 0)
EVAL_ROUTES = {"host": {}, "device_paste": {"device_paste": True},
               "device_score": {"device_score": True},
               "device_score_semantic": {"device_score": True}}


def eval_split(np, letterbox_image, size, sizes=EVAL_SIZES, seed=0):
    """The eval split, made with numpy from a seed and letterboxed with the
    port's ``letterbox_image``: (images, names, windows, original sizes)."""
    rng = np.random.RandomState(seed)
    names, orig, images, windows = [], {}, [], []
    for i, g in enumerate(EVAL_GROUPS):
        h, w = sizes[g]
        canvas, window = letterbox_image(
            rng.randint(0, 256, (h, w, 3)).astype(np.uint8), size)
        names.append(f"{'lp'[g]}{i}")
        orig[names[-1]] = (h, w)
        images.append(canvas)
        windows.append(window)
    return np.stack(images), names, np.stack(windows), orig


def eval_ground_truth(np, ev, host, sizes, instances, instance_mask):
    """Ground truth from the host route's sweep ``host``: every second
    pasted detection (``instances(entry, h, w)``) as an instance of its
    class, and per image one triangle in a corner, rasterized, that no
    detection matches.  Sets ``ev``'s index, sizes, masks and semantic
    maps as ``Evaluator`` builds them."""
    ev.index = [d["imname"] for d in host]
    ev.gt_sizes = dict(sizes)
    ev.gt_masks, ev.gt_semantic = {}, {}
    for det in host:
        nm = det["imname"]
        h, w = sizes[nm]
        objs = [{"imageid": nm, "classid": i["classid"], "difficult": 0,
                 "mask": i["mask"]}
                for i in instances(det, h, w)[::2] if i["mask"].any()]
        poly = [{"type": "out", "all_points_x": [2, w // 12, 2],
                 "all_points_y": [h - 3, h - 3, h - h // 12]}]
        objs.append({"imageid": nm, "classid": 2, "difficult": 0,
                     "mask": instance_mask(poly, h, w)})
        sem = np.zeros((h, w), np.uint8)
        for o in objs:
            sem[o["mask"]] = o["classid"] + 1
        ev.gt_masks[nm], ev.gt_semantic[nm] = objs, sem


def eval_route_kwargs(ev, route, cache):
    kw = dict(EVAL_ROUTES[route])
    if route != "host":
        kw.update(gt_sizes=ev.gt_sizes, paste_cache=cache)
    if route.startswith("device_score"):
        kw["gt_records"] = ev.gt_masks
    if route == "device_score_semantic":
        kw["gt_semantic"] = ev.gt_semantic
    return kw


def eval_score(ev, route, detdata):
    """The metrics of one sweep (AP, mAP, recall, precision) and its mIoU:
    from the semantic maps (host, device_paste), from the confusion
    totals (device_score_semantic) or none (device_score)."""
    res = ev.evaluate_detections(detdata,
                                 collect_semantic=route in ("host", "device_paste"))
    metrics = {k: res[k] for k in ("AP", "mAP", "recall", "precision")}
    if "semantic_maps" in res:
        miou = ev.miou(res["semantic_maps"])
    elif route == "device_score_semantic":
        miou = ev.miou_from_confusions({d["imname"]: d["confusion"]
                                        for d in detdata})
    else:
        miou = None
    return metrics, miou, res["t_post_s"]


def eval_checks(np, ev, out, packed_overlaps):
    """What the routes' fetched arrays must agree on, exactly: boxes and
    validity across the device routes; each ``device_score`` IoU row
    against the host popcount over ``device_paste``'s packed masks; the
    confusion totals against the host bincount over ``device_paste``'s
    semantic maps.  Returns the number of IoU rows and confusion
    matrices compared."""
    n = ev.cfg.num_class + 1
    rows = confs = 0
    paste_by = {d["imname"]: d for d in out["device_paste"]}
    for route in ("device_score", "device_score_semantic"):
        for d in out[route]:
            p = paste_by[d["imname"]]
            need(np.array_equal(d["boxes"], p["boxes"])
                 and np.array_equal(d["valid"], p["valid"]),
                 f"eval {route} {d['imname']}: detections differ from device_paste")
            gts = ev.gt_masks[d["imname"]]
            gt_packed = np.stack([np.packbits(o["mask"], axis=-1) for o in gts])
            gt_areas = np.asarray([int(o["mask"].sum()) for o in gts], np.int64)
            for k in np.flatnonzero(d["valid"]):
                want = packed_overlaps(p["full_masks_packed"][k], gt_packed, gt_areas)
                need(np.array_equal(d["iou"][k, :len(gts)], want),
                     f"eval {route} {d['imname']} row {k}: IoU != host popcount")
                rows += 1
            if route == "device_score_semantic":
                joint = (ev.gt_semantic[d["imname"]].astype(np.int64).ravel() * n
                         + p["semantic"].astype(np.int64).ravel())
                want = np.bincount(joint, minlength=n * n).reshape(n, n)
                need(np.array_equal(d["confusion"], want),
                     f"eval {d['imname']}: confusion totals != host bincount")
                confs += 1
    return rows, confs


def eval_modules():
    """The port's evaluation path, as one namespace."""
    from dis_yolo_tpu_torch.data.rasterize import instance_mask
    from dis_yolo_tpu_torch.data.val_data import letterbox_image
    from dis_yolo_tpu_torch.eval.map_eval import Evaluator
    from dis_yolo_tpu_torch.eval.postprocess import detections_to_original
    from dis_yolo_tpu_torch.eval.sweep import run_split
    from dis_yolo_tpu_torch.eval.voc_eval import packed_overlaps
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.utils.runtime import calibrate_threshold
    return types.SimpleNamespace(**locals())


def eval_phase(np, torch, m, cfg, state_dict, device=None, sizes=EVAL_SIZES):
    """The evaluation path: the eval split through ``run_split``'s routes
    with the default NMS (K1) and with ``use_pallas_nms`` (K1 + K2),
    scored by ``Evaluator``; fails unless every route gives the same AP,
    mAP, recall and precision, with 0 < AP < 1 for a class, and
    ``eval_checks`` holds.  Returns (record, (cfg, model, evaluator,
    split)) for the timing."""
    size = cfg.test_size
    images, names, windows, orig = eval_split(np, m.letterbox_image, size, sizes)
    dev = m.api.resolve_device(device)
    base = m.api.create_model(cfg, device)
    base.load_state_dict(state_dict)
    thresh = m.calibrate_threshold(base, torch.from_numpy(images[:1]).to(dev), cfg)
    ecfg = cfg.replace(obj_threshold=thresh)
    models = {}
    for k2 in (False, True):
        models[k2] = m.api.create_model(ecfg.replace(use_pallas_nms=k2), device)
        models[k2].load_state_dict(state_dict)
    del base
    ev = m.Evaluator(ecfg, "test", with_semantic=True, annotations=[], index=[])

    def instances(det, h, w):
        return m.detections_to_original(det["boxes"], det["masks"], h, w, size)

    host, _ = m.run_split(ecfg, models[False], images, names, windows, device=device)
    eval_ground_truth(np, ev, host, orig, instances, m.instance_mask)
    n_gt = sum(len(v) for v in ev.gt_masks.values())

    results, checks = {}, {}
    for k2 in (False, True):
        cache, out = {}, {}
        for route in EVAL_ROUTES:
            out[route], _ = m.run_split(ecfg, models[k2], images, names, windows,
                                        device=device,
                                        **eval_route_kwargs(ev, route, cache))
            results[(k2, route)] = eval_score(ev, route, out[route])[:2]
        checks[k2] = eval_checks(np, ev, out, m.packed_overlaps)
        # a second sweep on the same cache: nothing uploaded or built again
        held = dict(cache)
        again, _ = m.run_split(ecfg, models[k2], images, names, windows, device=device,
                               **eval_route_kwargs(ev, "device_score", cache))
        need(set(cache) == set(held) and all(cache[k] is v for k, v in held.items()),
             "eval: the second device_score sweep rebuilt or re-uploaded its cache")
        for a, b in zip(again, out["device_score"]):
            need(all(np.array_equal(a[key], b[key]) for key in ("boxes", "valid", "iou")),
                 f"eval: the second device_score sweep differs on {a['imname']}")
        need(eval_score(ev, "device_score", again)[0] == results[(k2, "device_score")][0],
             "eval: the second device_score sweep scores differently")
        if k2:
            for a, b in zip(out["device_paste"], paste_default):
                need(all(np.array_equal(a[key], b[key]) for key in a if key != "imname"),
                     f"eval: device_paste with use_pallas_nms differs on {a['imname']}")
        else:
            paste_default = out["device_paste"]
    first = results[(False, "host")][0]
    for key, (metrics, _) in results.items():
        need(metrics == first, f"eval: route {key} scores {metrics}, host route {first}")
    need(any(0.0 < ap < 1.0 for ap in first["AP"]),
         f"eval: no class with 0 < AP < 1: {first['AP']}")
    mious = {f"{route}{'_k2' if k2 else ''}": r[1] for (k2, route), r in results.items()}
    for k2 in ("", "_k2"):
        need(mious["device_paste" + k2] == mious["device_score_semantic" + k2],
             f"eval: mIoU from confusion totals != from semantic maps: {mious}")
    record = {"threshold": thresh, "images": len(names),
              "sizes_hw": [list(s) for s in sizes], "gt_instances": n_gt,
              "valid_detections": int(sum(int(d["valid"].sum()) for d in again)),
              "metrics": first, "miou": mious,
              "iou_rows_and_confusions_checked": {str(k): v for k, v in checks.items()}}
    return record, (ecfg, models[False], ev, (images, names, windows))


def eval_timing(m, ecfg, model, ev, split, device=None, repeats=3):
    """Seconds per image of each route: the device's predict (the copies to
    the host included) and the host's post-processing (the evaluator's
    ``t_post_s``), as the reference split them; the median of ``repeats``
    sweeps after a warm one, each route on its own persistent cache (a
    periodic validation's steady state)."""
    images, names, windows = split
    n, out = len(names), {}
    routes = {"host": "host", "device_paste": "device_paste",
              "device_score": "device_score"}
    for label, route in routes.items():
        cache, runs = {}, []
        kw = eval_route_kwargs(ev, route, cache)
        if route == "device_paste":      # the mAP sweep: no semantic maps
            kw["want_semantic"] = False
        for i in range(repeats + 1):
            timing = {}
            det, t_pred = m.run_split(ecfg, model, images, names, windows,
                                      device=device, timing=timing, **kw)
            t_post = ev.evaluate_detections(det)["t_post_s"]
            if i:
                runs.append({"predict_s": t_pred, "post_s": t_post,
                             "fetch_wait_s": timing.get("fetch_s", 0.0)})

        def med(key):
            return sorted(r[key] for r in runs)[len(runs) // 2] / n

        out[label] = {"predict_s_per_image": med("predict_s"),
                      "post_s_per_image": med("post_s"),
                      "fetch_wait_s_per_image": med("fetch_wait_s"),
                      "runs": runs}
    return out


# the Solver's split: 8 train and 4 val images, half landscape
# and half portrait (h, w), stored as binary PPM under .jpg names
SOLVER_SIZES = ((720, 960), (960, 720))
SOLVER_SPLIT = {"train": 8, "val": 4}
SOLVER_CLASSES = ("crack", "spall", "rebar")


def solver_split(np, root, rasterize, image_io, sizes=SOLVER_SIZES, seed=0):
    """Write the seeded split under ``root``: concrete-like texture with
    1-4 polygons darkened per image (VIA regions over the 3 classes),
    ``images/<stem>.jpg`` as P6, ``cache/ground_truth_cache.pkl`` (regions
    and size) and ``cache/<phase>.txt``.  Needs no OpenCV or PIL."""
    import pickle
    rng = np.random.RandomState(seed)
    for phase, n in SOLVER_SPLIT.items():
        img_dir = os.path.join(root, phase, "images")
        cache_dir = os.path.join(root, phase, "cache")
        os.makedirs(img_dir)
        os.makedirs(cache_dir)
        annotations, stems = [], []
        for i in range(n):
            h, w = sizes[i % 2]
            img = rng.normal(140, 25, (h, w, 3))
            regions = {}
            for r in range(rng.randint(1, 5)):
                cx, cy = rng.randint(w // 8, 7 * w // 8), rng.randint(h // 8, 7 * h // 8)
                rad = rng.randint(min(h, w) // 20, min(h, w) // 5)
                ang = np.sort(rng.uniform(0, 2 * np.pi, rng.randint(4, 12)))
                rr = rad * rng.uniform(0.5, 1.0, ang.size)
                xs = np.clip(cx + rr * np.cos(ang), 0, w - 1).astype(int).tolist()
                ys = np.clip(cy + rr * np.sin(ang), 0, h - 1).astype(int).tolist()
                shape = [{"type": "out", "all_points_x": xs, "all_points_y": ys}]
                img[rasterize.instance_mask(shape, h, w)] *= 0.4
                regions[str(r)] = {"region_attributes": SOLVER_CLASSES[rng.randint(3)],
                                   "shape_attributes": shape}
            stem = f"{phase}{i:04d}"
            image_io.write_ppm(os.path.join(img_dir, stem + ".jpg"),
                               img.clip(0, 255).astype(np.uint8))
            annotations.append({"filename": stem + ".jpg", "regions": regions,
                                "size": [h, w]})
            stems.append(stem)
        with open(os.path.join(cache_dir, "ground_truth_cache.pkl"), "wb") as f:
            pickle.dump(annotations, f)
        with open(os.path.join(cache_dir, f"{phase}.txt"), "w") as f:
            f.write("".join(s + "\n" for s in stems))


def host_state(torch, solver):
    """A host copy of a Solver's train state: weights, Adam's moments and
    counters, the step."""
    st = solver.state
    return {"model": {k: v.detach().cpu().clone()
                      for k, v in solver.model.state_dict().items()},
            "mu": {k: v.detach().cpu().clone() for k, v in st.opt.mu.items()},
            "nu": {k: v.detach().cpu().clone() for k, v in st.opt.nu.items()},
            "count": st.opt.count, "total_notfinite": st.opt.total_notfinite,
            "step": st.step}


def tensors_equal(a, b):
    return set(a) == set(b) and all(a[k].equal(b[k]) for k in a)


def timed_stop(loader, limit=10.0):
    """Seconds ``loader.stop()`` took; fails the run past ``limit``."""
    import threading
    t0 = time.monotonic()
    th = threading.Thread(target=loader.stop, daemon=True)
    th.start()
    th.join(limit)
    need(not th.is_alive(), f"ParallelTrainData.stop() did not return in {limit} s")
    return time.monotonic() - t0


def solver_modules():
    """The port's training loop, as one namespace."""
    from dis_yolo_tpu_torch import cli
    from dis_yolo_tpu_torch.data import dataset, image_io, rasterize
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.train import checkpoint as ckpt
    from dis_yolo_tpu_torch.train import solver as solver_mod
    from dis_yolo_tpu_torch.train import train_step as ts
    from dis_yolo_tpu_torch.utils import profiling
    return types.SimpleNamespace(**locals())


def solver_phase(np, torch, m, root, size=576, device="cuda", sizes=SOLVER_SIZES):
    """The training loop through ``cli.main``, in process: stage 1 (6
    steps, a checkpoint and a validation every 3), stage 2 from stage 1's
    step 6 (``--weights-from``, 3 steps), and a resume of run 1
    (``--restore auto``, to step 9); then the same split through
    ``ParallelTrainData`` with 2 spawned workers against workers=0.
    Fails unless every logged loss is finite, layers 1-52 are unchanged
    across stage 1, the checkpoints and ``best.json`` are in place, the
    resumed state is the saved one bit for bit, stage 2 starts from the
    stage-1 weights with a fresh optimizer, validation mAP is in [0, 1],
    the pool's batches equal the inline ones and its stop is bounded.
    Returns (record, the Solvers of the three runs)."""
    solver_split(np, root, m.rasterize, m.image_io, sizes)
    out1, out2 = os.path.join(root, "run1"), os.path.join(root, "run2")
    common = ["--dataset", root, "--image-size", str(size), "--batch-size", "2",
              "--summary-iter", "1", "--save-iter", "3", "--device", device]
    entry, solvers = [], []
    real_train = m.solver_mod.Solver.train

    def train(self, max_iter=None):
        entry.append(host_state(torch, self))
        t0 = time.perf_counter()
        state = real_train(self, max_iter)
        self.wall_s = time.perf_counter() - t0
        solvers.append(self)
        return state

    m.solver_mod.Solver.train = train
    try:
        m.cli.main(["train", "--stage", "1", "--max-iter", "6",
                    "--output-dir", out1] + common)
        ckpt_dir = os.path.join(out1, "checkpoint")
        steps1 = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
        best = m.ckpt.read_best(ckpt_dir)
        step6 = os.path.join(ckpt_dir, "step_00000006")
        saved6 = torch.load(os.path.join(step6, "state"), weights_only=True)
        m.cli.main(["train", "--stage", "2", "--max-iter", "3", "--output-dir", out2,
                    "--weights-from", step6] + common)
        m.cli.main(["train", "--stage", "1", "--max-iter", "9", "--output-dir", out1,
                    "--restore", "auto"] + common)
    finally:
        m.solver_mod.Solver.train = real_train
    need(steps1 == ["step_00000003", "step_00000006"], f"stage 1 checkpoints: {steps1}")
    need(best is not None and best["step"] in (3, 6), f"best.json: {best}")
    run1_end = host_state(torch, solvers[0])
    locked_keys = [k for k in entry[0]["model"]
                   if m.ts.layer_id(k) in solvers[0].cfg.locked_layers]
    need(len(locked_keys) > 0 and all(entry[0]["model"][k].equal(run1_end["model"][k])
                                      for k in locked_keys),
         "stage 1 moved a locked layer (1-52)")
    need(tensors_equal(run1_end["model"], saved6["model"])
         and tensors_equal(run1_end["mu"], saved6["mu"]),
         "stage 1's final state differs from its step-6 checkpoint")
    # stage 2: the stage-1 weights, a fresh optimizer and step
    s2 = entry[1]
    need(tensors_equal(s2["model"], saved6["model"]),
         "stage 2 did not start from stage 1's step-6 weights")
    need(s2["count"] == 0 and s2["step"] == 0 and s2["mu"]
         and all(not v.any() for v in s2["mu"].values())
         and all(not v.any() for v in s2["nu"].values()),
         "stage 2 did not start with a fresh optimizer")
    # the resume: every tensor, Adam's count and the step as saved
    r = entry[2]
    need(r["step"] == saved6["step"] == 6 and r["count"] == saved6["count"] == 6,
         f"resume at step {r['step']} count {r['count']}, saved "
         f"{saved6['step']} / {saved6['count']}")
    need(tensors_equal(r["model"], saved6["model"]) and tensors_equal(r["mu"], saved6["mu"])
         and tensors_equal(r["nu"], saved6["nu"]),
         "the resumed state differs from the step-6 checkpoint")
    need(solvers[2].state.step == 9 and os.path.isdir(os.path.join(ckpt_dir, "step_00000009")),
         "the resumed run did not reach step 9")
    rows = []
    for out in (out1, out2):
        with open(os.path.join(out, "checkpoint", "train_metrics.jsonl")) as f:
            rows += [json.loads(line) for line in f]
    train_rows = [r_ for r_ in rows if r_["kind"] == "train"]
    val_rows = [r_ for r_ in rows if r_["kind"] == "val"]
    need(len(train_rows) == 6 + 3 + 3, f"{len(train_rows)} metric rows, expected 12")
    need(all(np.isfinite(v) for r_ in train_rows for k, v in r_.items()
             if k not in ("ts", "kind")), "a logged training metric is not finite")
    need(all(r_["skipped_nonfinite"] == 0 for r_ in train_rows),
         "a step was skipped as non-finite")
    need(len(val_rows) == 2 + 1 + 1 and all(0.0 <= r_["mAP"] <= 1.0 for r_ in val_rows),
         f"validation mAP out of [0, 1] or missing: {[r_['mAP'] for r_ in val_rows]}")
    # the pool: spawned workers against the inline stream, bounded stop
    cfg = solvers[0].cfg
    ref = m.dataset.ParallelTrainData(cfg, "train", seed=4, workers=0)
    want = [ref.get() for _ in range(3)]
    pool = m.dataset.ParallelTrainData(cfg, "train", seed=4, workers=2)
    pool.start_prefetch()
    got = [pool.next_prefetched() for _ in range(3)]
    stop_s = timed_stop(pool)
    for i, (g, w) in enumerate(zip(got, want)):
        need(all(np.array_equal(g[k], w[k]) for k in w),
             f"ParallelTrainData workers=2 batch {i} differs from workers=0")
    record = {
        "split": {k: v for k, v in SOLVER_SPLIT.items()},
        "sizes_hw": [list(s) for s in sizes],
        "stage1_checkpoints": steps1, "best": best,
        "train_losses": [r_["total_loss"] for r_ in train_rows],
        "val_mAP": [r_["mAP"] for r_ in val_rows],
        "locked_entries_unchanged": len(locked_keys),
        "resume_step": r["step"], "parallel_loader_stop_s": stop_s,
        "runs": [{"stage": 2 if i == 1 else 1, "steps": s.train_timer.calls,
                  "wall_s": s.wall_s,
                  "train_timer_s_per_step": s.train_timer.average_time,
                  "load_timer_s_per_step": s.load_timer.average_time}
                 for i, s in enumerate(solvers)]}
    return record, solvers


def solver_window(torch, solver, steps, wall_ms_per_step, skip=2, top=5):
    """One torch.profiler window over ``steps`` steps of ``solver.train``,
    after ``skip`` steps of the same call (the loader's start is outside
    the window; the waits for the next batches are inside): device busy
    time (the union of the kernels' and copies' intervals), its idle
    share against the unprofiled ``wall_ms_per_step``, device launches
    per step, and the ``top`` largest gaps between device work, each
    with the device work around it and the innermost torch ops running
    on the host across its middle (none: the host ran Python, such as
    the wait for a batch)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    real, calls, clock = solver.step_fn, [0], {}

    def step_fn(*a):
        if calls[0] == skip:
            torch.cuda.synchronize()
            prof.start()
            clock["t0"] = time.perf_counter()
        out = real(*a)
        calls[0] += 1
        if calls[0] == skip + steps:
            torch.cuda.synchronize()
            clock["t1"] = time.perf_counter()
            prof.stop()
        return out

    solver.step_fn = step_fn
    try:
        solver.train(max_iter=solver.state.step + skip + steps)
    finally:
        solver.step_fn = real
    wall_us = (clock["t1"] - clock["t0"]) * 1e6 / steps
    cuda_t = torch.autograd.DeviceType.CUDA
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == cuda_t)
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in events if e.device_type != cuda_t]
    if not dev:
        return {"device_busy_us_per_step": "not measured"}
    busy, gaps, end = 0.0, [], dev[0][0]
    prev = dev[0][2]
    for start, stop, name in dev:
        if start > end:
            gaps.append((start - end, end, start, prev, name))
        busy += max(0.0, stop - max(start, end))
        if stop > end:
            end, prev = stop, name
    largest = []
    for gap, a, b, before, after in sorted(gaps, reverse=True)[:top]:
        mid = (a + b) / 2
        around = sorted((s1 - s0, n) for s0, s1, n in host if s0 <= mid <= s1)
        largest.append({"gap_us": gap, "after": before[:80], "before": after[:80],
                        "host_ops_across": [n for _, n in around[:3]]})
    return {"steps": steps, "wall_us_per_step_profiled": wall_us,
            "device_busy_us_per_step": busy / steps,
            "device_idle_share": 1 - busy / steps / (wall_ms_per_step * 1e3),
            "device_launches_per_step": len(dev) / steps,
            "gaps_total_us_per_step": sum(g[0] for g in gaps) / steps,
            "gaps_over_1ms": sum(1 for g in gaps if g[0] > 1e3),
            "largest_gaps": largest}


def solver_timing_run(np, torch, m, root, cfg, state_dict, device="cuda", steps=10):
    """Phase 4's numbers of the training loop: ``build_example`` ms per
    example at ``cfg.image_size`` (one thread, cold and warm caches);
    ``ParallelTrainData`` batches/s with 0, 2 and 4 workers; the Solver's
    wall, ``train_timer`` and ``load_timer`` s/step over ``steps`` steps
    after 3 warm ones, stage 1 and stage 2 with the prefetch thread
    (``loader_workers=0``, the default) and stage 1 with 4 worker
    processes (no validation); a profiler window of 5 stage-1 Solver
    steps; the blocking ms of
    ``save_checkpoint_background``; and ``forward_stages``."""
    out = {}
    labels = m.dataset.load_labels(cfg, "train")
    rng = np.random.RandomState(0)
    masks, images = m.dataset.MaskCache(), m.dataset.ImageCache()

    def examples(n):
        t0 = time.perf_counter()
        for i in range(n):
            m.dataset.build_example(cfg, labels[i % len(labels)], rng, True,
                                    masks, images.load)
        return (time.perf_counter() - t0) * 1e3 / n

    out["build_example_ms_cold"] = examples(len(labels))
    out["build_example_ms_warm"] = examples(4 * len(labels))
    rates = {}
    for workers in (0, 2, 4):
        loader = m.dataset.ParallelTrainData(cfg, "train", seed=0, workers=workers)
        loader.start_prefetch()
        loader.next_prefetched()
        t0 = time.perf_counter()
        for _ in range(10):
            loader.next_prefetched()
        rates[f"workers_{workers}"] = 10 / (time.perf_counter() - t0)
        timed_stop(loader)
    out["parallel_loader_batches_per_s"] = rates

    for key, locked, workers in (("solver_stage1", tuple(range(1, 53)), 0),
                                 ("solver_stage2", (), 0),
                                 ("solver_stage1_loader_workers4",
                                  tuple(range(1, 53)), 4)):
        scfg = cfg.replace(locked_layers=locked, save_iter=10 ** 6,
                           summary_iter=10 ** 6, loader_workers=workers,
                           output_dir=os.path.join(root, f"timing_{key}"))
        solver = m.solver_mod.Solver(scfg, seed=0, device=device)
        solver.model.load_state_dict(state_dict)
        solver.train(max_iter=3)
        solver.load_timer, solver.train_timer = type(solver.load_timer)(), \
            type(solver.train_timer)()
        t0 = time.perf_counter()
        solver.train(max_iter=3 + steps)
        wall = (time.perf_counter() - t0) / steps
        out[key] = {
            "steps": steps, "loader_workers": workers, "wall_s_per_step": wall,
            "train_timer_s_per_step": solver.train_timer.average_time,
            "load_timer_s_per_step": solver.load_timer.average_time}
        if key == "solver_stage1":
            out["solver_trace_stage1"] = solver_window(torch, solver, 5, wall * 1e3)
            ck = os.path.join(root, "ckpt_timing")
            t0 = time.perf_counter()
            m.ckpt.save_checkpoint_background(ck, solver.state, solver.state.step)
            blocking = time.perf_counter() - t0
            m.ckpt.wait_for_checkpoints()
            out["checkpoint_background_ms"] = {
                "blocking": blocking * 1e3,
                "total": (time.perf_counter() - t0) * 1e3,
                "state_bytes": sum(os.path.getsize(os.path.join(d, f))
                                   for d, _, fs in os.walk(ck) for f in fs)}
        del solver
        torch.cuda.empty_cache()

    x = torch.from_numpy(np.random.RandomState(1).rand(
        1, cfg.image_size, cfg.image_size, 3).astype(np.float32)).to(device)
    net = m.api.create_model(cfg, device)
    net.load_state_dict(state_dict)
    out["forward_stages_b1"] = forward_stages(torch, m.profiling, net, x)
    return out


def forward_stages(torch, profiling, net, x, calls=10):
    """Device and idle ms per forward of each stage span
    (``dis_yolo.backbone``, ``.heads``, ``.mask_decoder``) over ``calls``
    full forwards in one profiled window with the spans on, after one
    warm forward; ``unspanned`` is what ran outside them (the window's
    ends, between the forwards)."""
    from port_bench import program_trace
    with torch.no_grad():
        net(x)
        tables = []
        with program_trace.profiled(calls, tables, profiling):
            for _ in range(calls):
                net(x)
    t = tables[0]
    return {"calls": calls, "busy_ms": t["busy_ms"], "window_ms": t["window_ms"],
            "stages": {name.split(".", 1)[1]: t["spans"].get(name, "not measured")
                       for name in program_trace.FORWARD_SPANS},
            "unspanned": t["unspanned"]}

# the device-data training phase: the P6 split of solver_split, on-card
# augmentation and corpus assembly, K-step blocks, grad_accum, remat and
# the command with --device-corpus
def device_data_modules():
    """The on-device training data path and the training knobs, as one
    namespace."""
    from dis_yolo_tpu_torch import cli
    from dis_yolo_tpu_torch.config import DISYoloConfig
    from dis_yolo_tpu_torch.data import dataset, device_augment, device_corpus
    from dis_yolo_tpu_torch.losses.mask_loss import draw_uniforms
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.train import checkpoint as ckpt
    from dis_yolo_tpu_torch.train import solver as solver_mod
    from dis_yolo_tpu_torch.train import train_step as ts
    from dis_yolo_tpu_torch.train.synthetic import synthetic_batch
    return types.SimpleNamespace(**locals())


def to_dev(torch, batch, dev):
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(v)).to(dev)
            for k, v in batch.items()}


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms and cuDNN (cuBLAS's workspace is pinned by
    CUBLAS_WORKSPACE_CONFIG, set before the card is first used)."""
    torch.use_deterministic_algorithms(True)
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def wire_batch(np, synthetic_batch, cfg, seed=0):
    """A seeded synthetic batch in the loader's wire format (uint8 images,
    packed masks)."""
    b, t = cfg.batch_size, cfg.max_box_per_image
    batch = synthetic_batch(cfg, b, 3, seed=seed)
    wire = dict(batch, images=(batch["images"] * 255).astype(np.uint8))
    wire["masks_packed"] = np.packbits(
        wire.pop("true_masks").reshape(b, t, -1), axis=-1)
    return wire


def check_augment(np, torch, m, cfg, wire, dev="cuda"):
    """``augment_batch`` on the card against the CPU on the same draws
    (drawn on the card, copied across), every flip and photometric branch
    forced in turn: flips, masks, boxes and grids exact, images within 1
    LSB.  Returns the record."""
    card = m.ts.prepare_batch(to_dev(torch, wire, dev))
    cpu = {k: v.cpu() for k, v in card.items()}
    gen = torch.Generator(device=dev).manual_seed(11)
    lsb, off, total = 0.0, 0, 0
    for r in range(4):
        draws = m.device_augment.draw_augment(gen, 2, cfg.image_size)
        draws["flip"] = torch.tensor([1 + r % 3, 1 + (r + 1) % 3], device=dev)
        draws["bnl"] = torch.tensor([1 + r, 1 + (r + 2) % 4], device=dev)
        got = m.device_augment.augment_batch(card, draws, cfg.image_size)
        want = m.device_augment.augment_batch(
            cpu, {k: v.cpu() for k, v in draws.items()}, cfg.image_size)
        for k in want:
            if k != "images":
                need(torch.equal(got[k].cpu(), want[k]),
                     f"augment card vs CPU: {k} differs (round {r})")
        d = (got["images"].cpu() - want["images"]).abs() * 255
        lsb = max(lsb, float(d.max()))
        off += int((d > 0.5).sum())
        total += d.numel()
    need(lsb <= 1.0 + 1e-3, f"augment card vs CPU: images off by {lsb} LSB")
    return {"max_lsb": lsb, "pixels_off": off, "pixels": total}


def check_assemble(np, torch, m, cfg, data, corpus_card, corpus_cpu, wire_loader,
                   dev="cuda"):
    """``make_assemble_fn`` on the card against the CPU on the same
    decisions (grids, boxes and windows exact, images within 1 LSB), and
    against ``build_example(host_augs=False)`` batches (the same, masks
    but for knife edges).  Returns the record."""
    assemble = m.device_corpus.make_assemble_fn(cfg)
    rec = {"img_max_lsb_cpu": 0, "img_max_lsb_wire": 0, "img_off_wire": 0,
           "mask_off_cpu": 0, "mask_off_wire": 0, "mask_pixels": 0, "pixels": 0}
    for _ in range(3):
        p = data._make_batch()
        got = {k: v.cpu() for k, v in assemble(corpus_card, to_dev(torch, p, dev)).items()}
        ref = assemble(corpus_cpu, to_dev(torch, p, "cpu"))
        wire = m.dataset.expand_batch(wire_loader._make_batch())
        for k in ("true_boxes", "labels_s8", "labels_s16", "labels_s32", "windows"):
            need(torch.equal(got[k], ref[k]), f"assemble card vs CPU: {k} differs")
            need(np.array_equal(got[k].numpy(), wire[k]),
                 f"assemble card vs build_example: {k} differs")
        img = got["images"].numpy().astype(np.int16)
        d_cpu = np.abs(img - ref["images"].numpy().astype(np.int16))
        d_wire = np.abs(img - np.round(wire["images"] * 255).astype(np.int16))
        rec["img_max_lsb_cpu"] = max(rec["img_max_lsb_cpu"], int(d_cpu.max()))
        rec["img_max_lsb_wire"] = max(rec["img_max_lsb_wire"], int(d_wire.max()))
        rec["img_off_wire"] += int((d_wire > 0).sum())
        rec["pixels"] += img.size
        msk = got["true_masks"].numpy()
        rec["mask_off_cpu"] += int((msk != ref["true_masks"].numpy()).sum())
        rec["mask_off_wire"] += int((msk != wire["true_masks"]).sum())
        rec["mask_pixels"] += msk.size
    need(rec["img_max_lsb_cpu"] <= 1 and rec["img_max_lsb_wire"] <= 1,
         f"assembled images off by more than 1 LSB: {rec}")
    need(rec["mask_off_cpu"] <= 1e-4 * rec["mask_pixels"]
         and rec["mask_off_wire"] <= 1e-3 * rec["mask_pixels"],
         f"assembled masks differ beyond knife edges: {rec}")
    return rec


def count_syncs(np, torch, m, cfg, data, corpus_card, dev="cuda"):
    """Host syncs of the device-data path's own work on one batch whose
    decisions are already on the card: assemble, prepare, draw and
    augment (the step's three syncs are older), counted by PyTorch's
    sync debug mode after a warm call."""
    import warnings
    p = to_dev(torch, data._make_batch(), dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    assemble = m.device_corpus.make_assemble_fn(cfg)

    def work():
        batch = m.ts.prepare_batch(assemble(corpus_card, p))
        draws = m.device_augment.draw_augment(gen, cfg.batch_size, cfg.image_size)
        return m.device_augment.augment_batch(batch, draws, cfg.image_size)

    work()
    if dev != "cuda":
        return "not measured"
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            work()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message)[:120] for w in caught
             if "called a synchronizing" in str(w.message)]
    need(not syncs, f"the device-data path synchronizes with the host: {syncs[:3]}")
    return len(syncs)


def check_corpus_block(np, torch, m, cfg, data, corpus_card, state_dict, dev="cuda"):
    """A K=3 stage-1 block through ``make_corpus_multi_step`` against three
    single steps from the same state and generators, under deterministic
    algorithms: weights, moments and metrics bit-equal."""
    params = [data._make_batch() for _ in range(3)]
    assemble = m.device_corpus.make_assemble_fn(cfg)
    models = []
    for _ in range(2):
        net = m.api.create_model(cfg, device=dev)
        net.load_state_dict(state_dict)
        models.append(net)
    gens = [(torch.Generator().manual_seed(6),
             torch.Generator(device=dev).manual_seed(7)) for _ in range(2)]
    with deterministic(torch):
        s1 = m.ts.init_train_state(models[0], device=dev)
        step = m.ts.make_train_step(models[0], device=dev)
        rows = []
        for p in params:
            s1, met = step(s1, assemble(corpus_card, to_dev(torch, p, dev)), *gens[0])
            rows.append(met)
        s2 = m.ts.init_train_state(models[1], device=dev)
        block = {k: np.stack([p[k] for p in params]) for k in params[0]}
        s2, stacked = m.ts.make_corpus_multi_step(models[1], device=dev)(
            s2, corpus_card, block, *gens[1])
        torch.cuda.synchronize()
    sd1, sd2 = models[0].state_dict(), models[1].state_dict()
    differ = [k for k in sd1 if not sd1[k].equal(sd2[k])]
    need(not differ, f"corpus block vs 3 steps: {len(differ)} entries differ, "
                     f"e.g. {differ[:3]}")
    need(all(s1.opt.mu[k].equal(s2.opt.mu[k]) for k in s1.opt.mu),
         "corpus block vs 3 steps: Adam moments differ")
    need(all(torch.equal(stacked[k], torch.stack([r[k] for r in rows])) for k in stacked),
         "corpus block vs 3 steps: metrics differ")
    need(all(bool(torch.isfinite(v).all()) for v in stacked.values()),
         "corpus block: non-finite metrics")
    return {"steps": 3, "total_loss": stacked["total_loss"].tolist()}


def check_grad_accum(np, torch, m, cfg, wire, state_dict, dev="cuda"):
    """A float32 ``grad_accum=2`` step's averaged metrics, score-map head
    gradient and BN statistics, card (K1/K3, TF32 off) against the CPU,
    with the same uniforms and no proposals (the ROIs are the GT boxes),
    at the f32 train check's tolerances."""
    c32 = cfg.replace(compute_dtype="float32", locked_layers=(), obj_threshold=1.0,
                      grad_accum=2, device_side_augs=False, device_corpus=False)
    u_prop, u_gt = m.draw_uniforms(torch.Generator().manual_seed(3), c32.batch_size,
                                   c32.max_detection, c32.max_box_per_image, "cpu")
    out = {}
    for d in (dev, "cpu"):
        net = m.api.create_model(c32, device=d)
        net.load_state_dict(state_dict)
        net.requires_grad_(False)
        head = [net.convolutional82.conv.weight, net.convolutional82.conv.bias]
        for p_ in head:
            p_.requires_grad_(True)
        batch = m.ts.prepare_batch(to_dev(torch, wire, d))
        grads, mets = m.ts.grads_and_aux(net, batch, u_prop.to(d), u_gt.to(d), head)
        stats = {k: v.cpu() for k, v in net.state_dict().items() if "running" in k}
        out[d] = ({k: float(v) for k, v in mets.items()}, [g.cpu() for g in grads],
                  stats)
        del net
    (mc, gc, sc), (mr, gr, sr) = out[dev], out["cpu"]
    loss_rel = abs(mc["total_loss"] - mr["total_loss"]) / abs(mr["total_loss"])
    mask_rel = abs(mc["mask_loss"] - mr["mask_loss"]) / abs(mr["mask_loss"])
    grad_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(gc, gr))
    stat_err = max(float((sc[k] - sr[k]).abs().max()) / max(1.0, float(sr[k].abs().max()))
                   for k in sr)
    need(mr["mask_loss"] > 0, "grad_accum check: no positive ROI")
    need(loss_rel <= 1e-2 and mask_rel <= 1e-4 and grad_err <= 1e-3 and stat_err <= 1e-3,
         f"grad_accum=2 card vs CPU: total rel {loss_rel}, mask rel {mask_rel}, "
         f"head grad rel {grad_err}, stats rel {stat_err}")
    return {"total_loss_rel": loss_rel, "mask_loss_rel": mask_rel,
            "head_grad_rel": grad_err, "bn_stats_rel": stat_err}


def check_remat(np, torch, m, cfg, wire, state_dict, dev="cuda", steps=5):
    """One stage-2 step with ``remat`` against one without, from the same
    state, batch and generator (bf16, deterministic cuDNN): the same
    metrics and BN statistics; the peak device memory of each step above
    what was allocated before it.  Then each is timed under PyTorch's
    default cuDNN and TF32 settings (those of a training run): ``steps``
    steps after 2 warm ones, in two passes (plain, remat, plain, remat),
    with each pass's peak memory."""
    rec = {}
    states = {}
    for remat in (False, True):
        net = m.api.create_model(cfg.replace(locked_layers=(), remat=remat,
                                             device_side_augs=False,
                                             device_corpus=False), device=dev)
        net.load_state_dict(state_dict)
        st, step = m.ts.init_train_state(net, dev), m.ts.make_train_step(net, dev)
        batch = to_dev(torch, wire, dev)
        step(st, batch, torch.Generator().manual_seed(4))     # warm (cuDNN plans)
        net.load_state_dict(state_dict)
        st = m.ts.init_train_state(net, dev)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            st, met = step(st, batch, torch.Generator().manual_seed(5))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
        states[remat] = ({k: float(v) for k, v in met.items()},
                         {k: v.clone() for k, v in net.state_dict().items()})
        rec["remat" if remat else "plain"] = {"peak_above_before_gb": peak / 1e9}
        del net, st, step
        torch.cuda.empty_cache()
    (m0, s0), (m1, s1) = states[False], states[True]
    need(m0 == m1, f"remat step metrics differ: {m0} vs {m1}")
    stats = [k for k in s0 if "running" in k]
    need(all(s0[k].equal(s1[k]) for k in stats), "remat step moved the BN statistics "
         "differently")
    rec["param_max_abs_diff"] = max(float((s0[k] - s1[k]).abs().max())
                                    for k in s0 if "running" not in k
                                    and "num_batches" not in k)
    rec["total_loss"] = m0["total_loss"]
    timing = {"steps": steps, "plain": [], "remat": []}
    batch = to_dev(torch, wire, dev)
    for remat in (False, True, False, True):
        net = m.api.create_model(cfg.replace(locked_layers=(), remat=remat,
                                             device_side_augs=False,
                                             device_corpus=False), device=dev)
        net.load_state_dict(state_dict)
        st, step = m.ts.init_train_state(net, dev), m.ts.make_train_step(net, dev)
        gen = torch.Generator().manual_seed(4)
        for _ in range(2):
            st, _ = step(st, batch, gen)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            st, met = step(st, batch, gen)
        torch.cuda.synchronize()
        timing["remat" if remat else "plain"].append({
            "ms_per_step": (time.perf_counter() - t0) * 1e3 / steps,
            "peak_above_before_gb": (torch.cuda.max_memory_allocated() - before) / 1e9})
        need(np.isfinite(float(met["total_loss"])), "remat timing: non-finite loss")
        del net, st, step
        torch.cuda.empty_cache()
    rec["timing_default_settings"] = timing
    return rec


def device_data_phase(np, torch, m, root, state_dict, size=576, dev="cuda"):
    """The device-data training phase on the split of ``solver_split``
    under ``root``: ``check_augment``, the corpus (host build, upload,
    ``check_assemble``), ``check_corpus_block``, ``check_grad_accum`` and
    ``check_remat`` (``device_data_command`` runs the command).  Fails
    unless every check holds.  Returns the record."""
    cfg = m.DISYoloConfig(dataset=root, image_size=size, test_size=size,
                          device_side_augs=True, device_corpus=True,
                          steps_per_dispatch=3)
    rec = {}
    wire = wire_batch(np, m.synthetic_batch, cfg)
    rec["augment_card_vs_cpu"] = check_augment(np, torch, m, cfg, wire, dev)
    t0 = time.perf_counter()
    data = m.device_corpus.CorpusTrainData(cfg, "train", seed=5)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus_card = m.device_corpus.upload_corpus(data.corpus, dev)
    torch.cuda.synchronize()
    rec["corpus"] = {"images": data.corpus.n, "hw_max": list(data.corpus.hw_max),
                     "host_bytes": data.corpus.nbytes(),
                     "uploaded_bytes": sum(v.numel() * v.element_size()
                                           for v in corpus_card.values()),
                     "build_s": build_s, "upload_s": time.perf_counter() - t0}
    corpus_cpu = m.device_corpus.upload_corpus(data.corpus, "cpu")
    wire_loader = m.dataset.DefectTrainData(cfg, "train", seed=5, host_augs=False)
    rec["assemble_card_vs_cpu_and_wire"] = check_assemble(
        np, torch, m, cfg, data, corpus_card, corpus_cpu, wire_loader, dev)
    del corpus_cpu
    rec["host_syncs_assemble_augment"] = count_syncs(np, torch, m, cfg, data,
                                                     corpus_card, dev)
    rec["corpus_block_vs_steps"] = check_corpus_block(np, torch, m, cfg, data,
                                                      corpus_card, state_dict, dev)
    rec["grad_accum_card_vs_cpu"] = check_grad_accum(np, torch, m, cfg, wire, state_dict,
                                                      dev)
    rec["remat_stage2"] = check_remat(np, torch, m, cfg, wire, state_dict, dev)
    del corpus_card
    torch.cuda.empty_cache()
    print("device-data checks: " + json.dumps(rec), flush=True)
    return rec


def device_data_command(np, torch, m, root, size=576, dev="cuda"):
    """``cli train --device-corpus --steps-per-dispatch 3`` stage 1 for 6
    steps (a checkpoint every 3, no validation), then a resume to step 9.
    Fails unless every logged loss is finite, layers 1-52 are unchanged,
    the resume starts from the step-6 checkpoint bit for bit and reaches
    step 9.  Returns {"command": record}."""
    cfg = m.DISYoloConfig(dataset=root, image_size=size, test_size=size)
    out = os.path.join(root, "corpus_run")
    common = ["--dataset", root, "--image-size", str(size), "--batch-size", "2",
              "--summary-iter", "1", "--save-iter", "3", "--device", dev,
              "--output-dir", out, "--no-validation", "--device-corpus",
              "--steps-per-dispatch", "3"]
    entry, solvers = [], []
    real_train = m.solver_mod.Solver.train

    def train(self, max_iter=None):
        entry.append(host_state(torch, self))
        state = real_train(self, max_iter)
        solvers.append(self)
        return state

    m.solver_mod.Solver.train = train
    try:
        m.cli.main(["train", "--stage", "1", "--max-iter", "6"] + common)
        ckpt_dir = os.path.join(out, "checkpoint")
        steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
        saved6 = torch.load(os.path.join(ckpt_dir, "step_00000006", "state"),
                            weights_only=True)
        m.cli.main(["train", "--stage", "1", "--max-iter", "9", "--restore", "auto"]
                   + common)
    finally:
        m.solver_mod.Solver.train = real_train
    need(steps == ["step_00000003", "step_00000006"], f"corpus run checkpoints: {steps}")
    need(all(s.device_corpus is not None and s.cfg.device_side_augs for s in solvers),
         "the command did not run on the device corpus")
    need([s.train_timer.calls for s in solvers] == [2, 1],
         f"blocks per run: {[s.train_timer.calls for s in solvers]}, expected [2, 1]")
    end1 = host_state(torch, solvers[0])
    locked = [k for k in entry[0]["model"] if m.ts.layer_id(k) in cfg.locked_layers]
    need(locked and all(entry[0]["model"][k].equal(end1["model"][k]) for k in locked),
         "the corpus run moved a locked layer (1-52)")
    need(tensors_equal(end1["model"], saved6["model"]),
         "the corpus run's final state differs from its step-6 checkpoint")
    r = entry[1]
    need(r["step"] == 6 and tensors_equal(r["model"], saved6["model"])
         and tensors_equal(r["mu"], saved6["mu"]) and tensors_equal(r["nu"], saved6["nu"]),
         "the corpus resume differs from the step-6 checkpoint")
    need(solvers[1].state.step == 9, "the corpus resume did not reach step 9")
    with open(os.path.join(ckpt_dir, "train_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if '"train"' in line]
    need([r_["step"] for r_ in rows] == list(range(1, 10)),
         f"corpus run rows: {[r_['step'] for r_ in rows]}")
    need(all(np.isfinite(v) for r_ in rows for k, v in r_.items()
             if k not in ("ts", "kind")), "a logged corpus-run metric is not finite")
    record = {"checkpoints": steps, "blocks": [2, 1],
              "train_losses": [r_["total_loss"] for r_ in rows],
              "locked_entries_unchanged": len(locked)}
    del solvers, entry, saved6
    torch.cuda.empty_cache()
    return {"command": record}


def device_data_parts(np, torch, m, cfg, data, corpus, dev="cuda"):
    """Device ms per call (``graph_ms``, CUDA-graph replays) of the corpus
    step's data work on one batch's decisions at the main path's shapes:
    the whole assembly and its parts (``_taps``, the image placement, the
    mask placement on the corpus's mask words, the label grids), the mask
    placement of this slice's first design (every packed mask unpacked,
    resized through ``_resize_place`` and rounded; held equal to
    ``_place_masks`` first), ``prepare_batch``
    and ``augment_batch`` on fixed draws; ``draw_augment`` by CUDA events
    over 20 calls (its generator stays out of the graph)."""
    dc = m.device_corpus
    p = to_dev(torch, data._make_batch(), dev)
    size = cfg.image_size
    idx = p["idx"].long()
    imgs, words = corpus["images"][idx], corpus["mask_words"][idx]
    packed = torch.from_numpy(data.corpus.masks_packed).to(dev)[idx]
    hws = corpus["sizes"][idx].long()
    new_h, new_w, dy, dx = p["place"].long().unbind(-1)
    b, t = packed.shape[:2]
    hm, wm = imgs.shape[1], imgs.shape[2]

    def taps():
        return dc._taps(hws[:, 0], hws[:, 1], new_h, new_w, dy, dx, size)

    tp = taps()

    def unpacked_masks():
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
        bits = torch.bitwise_right_shift(packed[..., None], shifts) & 1
        masks = bits.reshape(b, t, -1)[:, :, :hm * wm].reshape(b, t, hm, wm)
        placed = dc._resize_place(masks.permute(0, 2, 3, 1), tp, 0.0)
        return torch.round(placed).permute(0, 3, 1, 2).bool()

    need(torch.equal(unpacked_masks(), dc._place_masks(words, t, tp)),
         "mask placement differs from the unpacked resize on the card")
    assemble = dc.make_assemble_fn(cfg)
    batch = assemble(corpus, p)
    prepared = m.ts.prepare_batch(batch)
    gen = torch.Generator(device=dev).manual_seed(13)
    draws = m.device_augment.draw_augment(gen, b, size)
    anchors = torch.as_tensor(np.asarray(cfg.anchors_array(), np.float32), device=dev)
    parts = {
        "assemble": lambda: assemble(corpus, p),
        "taps": taps,
        "place_images": lambda: dc._resize_place(imgs, tp, 127.0),
        "place_masks": lambda: dc._place_masks(words, t, tp),
        "place_masks_first_design": unpacked_masks,
        "grids": lambda: dc._grids(p["true_box_px"], p["true_box"], p["nvalid"],
                                   anchors, cfg.base_grid, cfg.anchors_per_scale,
                                   cfg.num_class, float(size)),
        "prepare_batch": lambda: m.ts.prepare_batch(batch),
        "augment_batch": lambda: m.device_augment.augment_batch(prepared, draws, size),
    }
    rec = {name: graph_ms(torch, fn, n=5, reps=4) for name, fn in parts.items()}
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        m.device_augment.draw_augment(gen, b, size)
    stop.record()
    torch.cuda.synchronize()
    rec["draw_augment_events"] = start.elapsed_time(stop) / 20
    return rec


def device_data_timing(np, torch, m, root, state_dict, size=576, steps=30, passes=2,
                       dev="cuda"):
    """Phase 4's numbers of the device-data path: the Solver's wall,
    ``train_timer`` and ``load_timer`` per step for the wire loader one
    step at a time and in blocks of 3, and the device corpus in blocks of
    3: each route warmed for 3 steps, then timed over ``steps`` steps (no
    validation) ``passes`` times, the routes in turn within each pass
    (the figure is the mean of the passes, ``spread`` their max/min - 1);
    a profiler window of 3 more steps of each (device busy time, idle
    share, launches); the bytes copied to the card per step, and the
    corpus's; and ``device_data_parts`` on the corpus route's batch."""
    out = {}
    base = m.DISYoloConfig(dataset=root, image_size=size, test_size=size,
                           save_iter=999999, summary_iter=999999)
    routes = {"wire_k1": {}, "wire_k3": {"steps_per_dispatch": 3},
              "corpus_k3": {"steps_per_dispatch": 3, "device_corpus": True,
                            "device_side_augs": True}}
    solvers = {}
    for key, kw in routes.items():
        scfg = base.replace(output_dir=os.path.join(root, f"timing_{key}"), **kw)
        solver = m.solver_mod.Solver(scfg, seed=0, device=dev)
        solver.model.load_state_dict(state_dict)
        solver.train(max_iter=3)
        solvers[key] = solver
        out[key] = {"steps": steps, "passes": []}
    for _ in range(passes):
        for key, solver in solvers.items():
            solver.load_timer, solver.train_timer = type(solver.load_timer)(), \
                type(solver.train_timer)()
            t0 = time.perf_counter()
            solver.train(max_iter=solver.state.step + steps)
            out[key]["passes"].append({
                "wall_s_per_step": (time.perf_counter() - t0) / steps,
                "train_timer_s_per_step": solver.train_timer.total_time / steps,
                "load_timer_s_per_step": solver.load_timer.total_time / steps})
    for key, solver in solvers.items():
        rec = out[key]
        for name in ("wall_s_per_step", "train_timer_s_per_step",
                     "load_timer_s_per_step"):
            vals = [p_[name] for p_ in rec["passes"]]
            rec[name] = sum(vals) / len(vals)
        walls = [p_["wall_s_per_step"] for p_ in rec["passes"]]
        rec["wall_spread"] = max(walls) / min(walls) - 1
        # three more steps (one block) in a profiler window: the device's
        # busy time, against the unprofiled wall for the idle share
        trace = profile_window(torch, lambda: solver.train(max_iter=solver.state.step + 3),
                               1, rec["wall_s_per_step"] * 3e3)
        rec["trace_3_steps"] = {k: trace[k] for k in (
            "wall_us_per_call_profiled", "device_busy_us_per_call", "device_idle_share",
            "kernel_launches_per_call", "device_us_by_kind")}
        sample = solver.data.get()
        rec["bytes_to_card_per_step"] = int(sum(v.nbytes for v in sample.values()))
        if solver.device_corpus is not None:
            rec["corpus_bytes_on_card"] = int(sum(
                v.numel() * v.element_size() for v in solver.device_corpus.values()))
            out["corpus_parts_device_ms"] = device_data_parts(
                np, torch, m, solver.cfg, solver.data, solver.device_corpus, dev)
    del solvers, solver
    torch.cuda.empty_cache()
    return out


# the serving export: four artifacts of the serving graphs at 576^2, each
# with the batches it serves, and the CLI's commands on the Solver's split
EXPORT_BATCHES = (1, 2, 3)
INFER_LINE = re.compile(r"(.+): (\d+) detections -> (.+) \(([\d.]+) ms\)$")


def png_pixels(np, path):
    """Decode a PNG written by ``data.image_io.write_png`` (8-bit RGB, no
    row filter) with zlib, checking each chunk's CRC: the card's machine
    has no image library."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    need(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        need(crc == zlib.crc32(kind + body) & 0xFFFFFFFF, f"{path}: bad CRC")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    need(bool((rows[:, 0] == 0).all()), f"{path}: unexpected row filter")
    return rows[:, 1:].reshape(h, w, 3)


# thresholds tried, in order, for the commands' check: the first at which
# infer's BN-folded graph and export's deploy graph (two roundings of the
# same function in bf16) keep the same number of instances on every image
INFER_THRESHOLDS = (0.25, 0.2, 0.15, 0.1, 0.05)
INFER_REPEATS = 5       # phase 4 times `cli infer` over the val images x 5


def export_modules():
    """The port's serving export, as one namespace."""
    from dis_yolo_tpu_torch import export as exp
    from dis_yolo_tpu_torch.data.image_io import read_image
    from dis_yolo_tpu_torch.data.val_data import letterbox_image
    from dis_yolo_tpu_torch.eval.postprocess import detections_to_original
    from dis_yolo_tpu_torch.models import fold
    from dis_yolo_tpu_torch.ops import custom_ops
    from dis_yolo_tpu_torch.train import checkpoint as ckpt
    return types.SimpleNamespace(**locals())


def command_graphs(np, m, api, base_cfg, ckpt, val_dir, size):
    """What ``cli infer --checkpoint`` and an exported artifact serve,
    computed here from the same checkpoint: infer's BN-folded graph and
    export's deploy graph, each over the val images as the command does
    (read, letterbox, predict, paste), at each of ``INFER_THRESHOLDS``
    until the two keep as many instances per image (and some).  Returns
    (the threshold, {threshold: {"folded": counts, "deploy": counts}})."""
    folded = api.init_model(base_cfg, 0)
    m.ckpt.restore_weights(ckpt, folded)
    sd = folded.state_dict()
    deploy = api.create_model(base_cfg.replace(deploy=True))
    deploy.load_state_dict(m.fold.deploy_variables(sd))
    folded.load_state_dict(m.fold.fold_batchnorm(sd))
    inputs = []
    for name in sorted(os.listdir(val_dir)):
        rgb = m.read_image(os.path.join(val_dir, name))
        inputs.append((os.path.splitext(name)[0], rgb.shape[:2],
                       *m.letterbox_image(rgb, size)))

    def counts(model, t):
        out = {}
        for stem, (h, w), canvas, window in inputs:
            dets, masks = api.predict(model, canvas[None], window[None], t)
            out[stem] = len(m.detections_to_original(
                dets[0].cpu().numpy(), masks[0].cpu().numpy(), h, w, size))
        return out

    ladder = {}
    for t in INFER_THRESHOLDS:
        ladder[repr(t)] = {"folded": counts(folded, t), "deploy": counts(deploy, t)}
        if ladder[repr(t)]["folded"] == ladder[repr(t)]["deploy"] \
                and sum(ladder[repr(t)]["folded"].values()) > 0:
            return t, ladder
    fail(f"the folded and deploy graphs disagree at every threshold: {ladder}")


def artifact_worker(spec_path: str) -> None:
    """``chip_smoke.py --artifact-worker SPEC``: a fresh process that
    imports torch and ``export.load_artifact`` (which imports only the
    custom operators), loads each artifact of the spec and runs it on the
    card at its batches, with K1's and K2's plain versions replaced by
    stubs that raise.  Saves the outputs to ``spec["out"]`` and prints one
    JSON line: per artifact and batch the launches of K1 and K2 read from
    their counters, with ``spec["time"]`` the predict ms (CUDA events),
    and which modules of the port's model code were imported (none)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dis_yolo_tpu_torch.export import load_artifact
    from dis_yolo_tpu_torch.ops import custom_ops
    from dis_yolo_tpu_torch.utils import profiling

    def stub(*args, **kwargs):
        raise AssertionError("a plain version ran inside a loaded artifact")

    custom_ops.assemble_masks_batch_plain = stub
    custom_ops.nms_plain = stub
    with open(spec_path) as f:
        spec = json.load(f)
    data = np.load(spec["inputs"])
    inputs = {b: (torch.from_numpy(data[f"images{b}"]).cuda(),
                  torch.from_numpy(data[f"windows{b}"]).cuda())
              for b in EXPORT_BATCHES}
    report, outs = {}, {}
    for art in spec["artifacts"]:
        t0 = time.perf_counter()
        run, meta = load_artifact(art["path"])
        rec = {"load_s": time.perf_counter() - t0, "in_shapes": meta["in_shapes"],
               "calls": {}}
        for b in art["batches"]:
            before = kernel_launches(profiling, "K1", "K2")
            dets, masks = run(*inputs[b])
            torch.cuda.synchronize()
            rec["calls"][str(b)] = {
                k: v - before[k]
                for k, v in kernel_launches(profiling, "K1", "K2").items()}
            outs[f"{art['name']}_b{b}_dets"] = dets.cpu().numpy()
            outs[f"{art['name']}_b{b}_masks"] = masks.cpu().numpy()
            if spec["time"] and b <= 2:
                rec[f"predict_ms_b{b}"] = cuda_ms(torch, lambda: run(*inputs[b]), 20)
            if spec["time"] and b == 1:
                rec["profile_b1"] = profile_window(
                    torch, lambda: run(*inputs[1]), 5, rec["predict_ms_b1"],
                    host_ops=True)
        report[art["name"]] = rec
        del run
    np.savez(spec["out"], **outs)
    report["model_modules"] = sorted(m for m in sys.modules
                                     if m.startswith("dis_yolo_tpu_torch.models"))
    report["jax_imported"] = "jax" in sys.modules or "dis_yolo_tpu" in sys.modules
    report["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(report), flush=True)


def run_worker(np, root, specs, images, windows, timed, timeout=900):
    """Run ``artifact_worker`` in a fresh process over ``specs`` [(name,
    path, batches)]; returns (its report, its outputs, wall s)."""
    data = {}
    for b in EXPORT_BATCHES:
        data[f"images{b}"] = images[b].cpu().numpy()
        data[f"windows{b}"] = windows[b].cpu().numpy()
    np.savez(os.path.join(root, "inputs.npz"), **data)
    spec = {"inputs": os.path.join(root, "inputs.npz"),
            "out": os.path.join(root, "outputs.npz"), "time": timed,
            "artifacts": [{"name": n, "path": p, "batches": list(bs)}
                          for n, p, bs in specs]}
    spec_path = os.path.join(root, "worker.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t0 = time.time()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--artifact-worker", spec_path], capture_output=True,
                          text=True, timeout=timeout)
    wall = time.time() - t0
    need(proc.returncode == 0, "artifact worker failed:\n" + proc.stdout[-3000:]
         + proc.stderr[-6000:])
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    outs = dict(np.load(spec["out"]))
    os.remove(spec["out"])
    return report, outs, wall


def run_cli(args, timeout=900):
    """``python -m dis_yolo_tpu_torch.cli ARGS`` from the repo root ->
    (stdout, wall s); fails on a non-zero exit."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "dis_yolo_tpu_torch.cli", *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.time() - t0
    need(proc.returncode == 0, f"cli {args[0]} failed:\n" + proc.stdout[-3000:]
         + proc.stderr[-6000:])
    return proc.stdout, wall


def infer_counts(np, out, out_dir, sizes):
    """Parse ``cli infer``'s lines -> ({stem: detections}, [ms per image]);
    each overlay ``<stem>.png`` decodes to its input's size."""
    counts, ms = {}, []
    for line in out.splitlines():
        m = INFER_LINE.match(line)
        if m:
            stem = os.path.splitext(os.path.basename(m.group(1)))[0]
            counts[stem] = int(m.group(2))
            ms.append(float(m.group(4)))
            need(m.group(3) == os.path.join(out_dir, stem + ".png"),
                 f"infer wrote {m.group(3)}")
    need(len(counts) == SOLVER_SPLIT["val"], f"infer: {len(counts)} images")
    for i in range(SOLVER_SPLIT["val"]):
        h, w = sizes[i % 2]
        got = png_pixels(np, os.path.join(out_dir, f"val{i:04d}.png")).shape
        need(got == (h, w, 3), f"infer overlay val{i:04d}.png: {got}")
    return counts, ms


def compare_artifact(torch, got, want, tag):
    """Loaded artifact vs live predict: class column and row order equal,
    detections within rtol 1e-5 / atol 1e-6, masks within atol 5e-4 (the
    JAX package's export tolerances); returns the largest differences."""
    (gd, gm), (wd, wm) = (torch.from_numpy(x) for x in got), want
    need(tuple(gd.shape) == tuple(wd.shape) and tuple(gm.shape) == tuple(wm.shape),
         f"{tag}: shapes {tuple(gd.shape)} {tuple(gm.shape)}")
    need(torch.equal(gd[..., 4], wd[..., 4]), f"{tag}: class column differs")
    need(torch.allclose(gd, wd, rtol=1e-5, atol=1e-6), f"{tag}: detections differ")
    need(torch.allclose(gm, wm, rtol=0, atol=5e-4), f"{tag}: masks differ")
    return {"dets_max_abs": float((gd - wd).abs().max()),
            "masks_max_abs": float((gm - wm).abs().max()),
            "bit_equal": bool(torch.equal(gd, wd) and torch.equal(gm, wm)),
            "detections": int((wd[..., 5] > 0).sum())}


def export_phase(np, torch, m, api, graphs, g_thresh, images, windows, root,
                 solver_root, state_dict, size=576):
    """The serving export at 576^2 on the card: the deploy graph at B=1 and
    at a dynamic batch (served at 1, 2, 3), the deploy graph with
    ``use_pallas_nms`` at B=1 and the int8 graph at B=1, each saved and
    loaded back in a fresh process (``artifact_worker``) and held against
    the live predict of the same graph; then the commands on the Solver's
    val images: ``cli infer`` with the Solver's step-6 checkpoint (it
    runs; its few boxes sit on the one-pixel edge of the degenerate-box
    drop, so its counts are reported, not compared), and with a
    checkpoint of the seed-7 weights (the BN-folded graph) against a
    ``cli export`` artifact of it (the deploy graph), at the first of
    ``INFER_THRESHOLDS`` where the two graphs keep as many instances per
    image here: each command's counts equal its graph's and each
    other's; and ``cli verify-gt`` (one PNG per image, of its size).
    Every overlay decodes to its image's size.  Returns (record, timing
    context)."""
    cfg_b, model_b = graphs["b"]
    cfg_d, model_d = graphs["d"]
    arts = [("deploy_b1", cfg_b, model_b, 1, g_thresh["b"], (1,)),
            ("deploy_dynamic", cfg_b, model_b, "b", g_thresh["b"], EXPORT_BATCHES),
            ("deploy_k2_b1", cfg_b.replace(use_pallas_nms=True), model_b, 1,
             g_thresh["b"], (1,)),
            ("int8_b1", cfg_d, model_d, 1, g_thresh["d"], (1,))]
    record, specs, live = {"artifacts": {}}, [], {}
    for name, gcfg, gm, bs, th, batches in arts:
        t0 = time.time()
        ep = m.exp.export_predict(gcfg, gm, bs, obj_thresh=th)
        t1 = time.time()
        path = os.path.join(root, name)
        blob = m.exp.save_artifact(ep, path, gcfg, obj_thresh=th)
        t2 = time.time()
        code = ep.graph_module.code
        need("dis_yolo.assemble_masks" in code, f"{name}: K1 is not in the graph")
        need("_assert_tensor_metadata" not in code, f"{name}: assert nodes left")
        need(("dis_yolo.nms" in code) == gcfg.use_pallas_nms,
             f"{name}: K2 in the graph: {'dis_yolo.nms' in code}")
        # K2 takes the fixpoint loop's place; the fallback stays
        need(("while_loop" in code) != gcfg.use_pallas_nms and "cond" in code,
             f"{name}: NMS control flow is not in the graph")
        record["artifacts"][name] = {
            "export_s": t1 - t0, "save_s": t2 - t1,
            "artifact_mb": os.path.getsize(blob) / 1e6,
            "range_constraints": str(ep.range_constraints)}
        print(f"export {name}: {t1 - t0:.1f} s + save {t2 - t1:.1f} s, "
              f"{os.path.getsize(blob) / 1e6:.1f} MB, ranges "
              f"{ep.range_constraints}", flush=True)
        del ep
        specs.append((name, path, batches))
        for b in batches:
            raws = api.forward(gm, images[b])
            live[(name, b)] = [x.cpu() for x in api.predict_from_outputs(
                gcfg, raws, windows[b], th)]
    report, outs, wall = run_worker(np, root, specs, images, windows, False)
    need(report["model_modules"] == [] and not report["jax_imported"],
         f"the artifact process imported model code: {report['model_modules']}")
    k2_arts = {n for n, gcfg, *_ in arts if gcfg.use_pallas_nms}
    worker_launches = {"K1": 0, "K2": 0}
    for name, _, batches in specs:
        rec = record["artifacts"][name]
        rec.update(load_s=report[name]["load_s"], in_shapes=report[name]["in_shapes"],
                   launches=report[name]["calls"], vs_live={})
        for b in batches:
            calls = report[name]["calls"][str(b)]
            need(calls == {"K1": 1, "K2": int(name in k2_arts)},
                 f"{name} B={b}: launches {calls}")
            for kname in worker_launches:
                worker_launches[kname] += calls[kname]
            got = (outs[f"{name}_b{b}_dets"], outs[f"{name}_b{b}_masks"])
            rec["vs_live"][str(b)] = compare_artifact(torch, got, live[(name, b)],
                                                      f"{name} B={b}")
        print(f"artifact {name}: loaded in {rec['load_s']:.1f} s, launches "
              f"{rec['launches']}, vs live {json.dumps(rec['vs_live'])}", flush=True)
    record["worker_wall_s"] = wall
    record["worker_launches"] = worker_launches
    # the commands, on the Solver's split (P6, no OpenCV or PIL)
    val_dir = os.path.join(solver_root, "val", "images")
    common = ["--image-size", str(size), "--dataset", solver_root, "--device", "cuda"]
    cli = {}
    solver_ckpt = os.path.join(solver_root, "run1", "checkpoint", "step_00000006")
    out, cli["infer_solver_checkpoint_wall_s"] = run_cli(
        ["infer", "--images", val_dir, "--out", os.path.join(root, "infer_solver"),
         "--checkpoint", solver_ckpt, "--threshold", "0.001"] + common)
    cli["solver_checkpoint_detections"] = infer_counts(
        np, out, os.path.join(root, "infer_solver"), SOLVER_SIZES)[0]
    # the seed-7 weights as a checkpoint, served both ways at a threshold
    # where the two graphs they serve agree
    ckpt = os.path.join(root, "seed7")
    os.makedirs(ckpt)
    torch.save({k: v.cpu() for k, v in state_dict.items()},
               os.path.join(ckpt, "weights"))
    thr, ladder = command_graphs(np, m, api, cfg_b.replace(deploy=False), ckpt,
                                 val_dir, size)
    print(f"commands' threshold {thr!r}; folded vs deploy graph instances per "
          f"threshold tried: {json.dumps(ladder)}", flush=True)
    cli.update(threshold=thr, graphs_by_threshold=ladder)
    out, cli["infer_checkpoint_wall_s"] = run_cli(
        ["infer", "--images", val_dir, "--out", os.path.join(root, "infer_ckpt"),
         "--checkpoint", ckpt, "--threshold", repr(thr)] + common)
    counts_ckpt, ms_ckpt = infer_counts(np, out, os.path.join(root, "infer_ckpt"),
                                        SOLVER_SIZES)
    out, cli["export_wall_s"] = run_cli(
        ["export", "--out", os.path.join(root, "cli_deploy"), "--checkpoint", ckpt,
         "--threshold", repr(thr), "--symbolic-batch"] + common)
    cli["export"] = json.loads(out.strip().splitlines()[-1])
    here = os.path.dirname(os.path.abspath(__file__))
    for key in ("artifact", "meta"):
        cli["export"][key] = os.path.relpath(cli["export"][key], here)
    out, cli["infer_artifact_wall_s"] = run_cli(
        ["infer", "--images", val_dir, "--out", os.path.join(root, "infer_art"),
         "--artifact", os.path.join(root, "cli_deploy")] + common)
    counts_art, ms_art = infer_counts(np, out, os.path.join(root, "infer_art"),
                                      SOLVER_SIZES)
    need(counts_ckpt == ladder[repr(thr)]["folded"],
         f"infer --checkpoint: {counts_ckpt} instances, its graph here "
         f"{ladder[repr(thr)]['folded']}")
    need(counts_art == ladder[repr(thr)]["deploy"],
         f"infer --artifact: {counts_art} instances, its graph here "
         f"{ladder[repr(thr)]['deploy']}")
    need(counts_art == counts_ckpt and sum(counts_ckpt.values()) > 0,
         f"infer: checkpoint {counts_ckpt} vs artifact {counts_art} detections")
    out, cli["verify_gt_wall_s"] = run_cli(["verify-gt", "--phase", "val"] + common)
    verify_dir = os.path.join(solver_root, "val", "verify")
    pngs = sorted(os.listdir(verify_dir))
    need(pngs == [f"val{i:04d}.png" for i in range(SOLVER_SPLIT["val"])],
         f"verify-gt wrote {pngs}")
    for i, name in enumerate(pngs):
        h, w = SOLVER_SIZES[i % 2]
        got = png_pixels(np, os.path.join(verify_dir, name)).shape
        need(got == (h, w, 3), f"verify-gt {name}: {got}")
    cli.update(detections_per_image=counts_ckpt, infer_checkpoint_ms_per_image=ms_ckpt,
               infer_artifact_ms_per_image=ms_art, verify_gt_images=len(pngs))
    record["cli"] = cli
    print(f"cli: the Solver's checkpoint: {cli['solver_checkpoint_detections']} "
          f"detections; seed-7: {counts_ckpt} by checkpoint and artifact; "
          f"export {cli['export']['bytes'] / 1e6:.1f} MB; verify-gt {len(pngs)} "
          "PNGs", flush=True)
    return record, (specs, model_b, model_d, g_thresh,
                    {"val_dir": val_dir, "checkpoint": ckpt, "threshold": thr,
                     "artifact": os.path.join(root, "cli_deploy"), "common": common})


def export_timing(np, torch, m, api, ctx, root, images, windows):
    """The loaded artifacts' predict ms at B=1 and B=2 (CUDA events, in a
    fresh process, with a profiler window at B=1) beside the live predict
    of the same graphs (CUDA events, here); the deploy artifact at B=1
    also loaded here, and its program as ``torch.export`` leaves it (with
    the assert nodes ``export_predict`` drops), alternating with the live
    predict twice, each with a profiler window of its host operators; and
    ``cli infer`` over
    ``INFER_REPEATS`` copies of the val images by each route (host clock
    per image)."""
    specs, model_b, model_d, g_thresh, cmd = ctx
    report, _, wall = run_worker(np, root, specs, images, windows, True)
    live = {}
    for b in (1, 2):
        live[f"deploy_b{b}"] = cuda_ms(
            torch, lambda: api.predict(model_b, images[b], windows[b], g_thresh["b"]), 20)
    live["int8_b1"] = cuda_ms(
        torch, lambda: api.predict(model_d, images[1], windows[1], g_thresh["d"]), 20)
    k2cfg = model_b.cfg.replace(use_pallas_nms=True)
    live["deploy_k2_b1"] = cuda_ms(torch, lambda: api.predict_from_outputs(
        k2cfg, api.forward(model_b, images[1]), windows[1], g_thresh["b"]), 20)
    loaded = {name: {k: v for k, v in report[name].items()
                     if k.startswith(("predict_ms", "profile"))}
              for name, _, _ in specs}
    # the deploy B=1 artifact in this process, beside the live graph
    path = dict((n, p) for n, p, _ in specs)["deploy_b1"]
    run_here, _ = m.exp.load_artifact(path)
    # the same program as torch.export leaves it, with the assert nodes
    # that export_predict drops
    with torch.no_grad():
        kept = torch.export.export(m.exp._Serve(model_b, model_b.cfg, g_thresh["b"],
                                                torch.device("cuda")),
                                   (images[1], windows[1])).module()
    n_asserts = sum(node.target is torch.ops.aten._assert_tensor_metadata.default
                    for gm in kept.modules() if isinstance(gm, torch.fx.GraphModule)
                    for node in gm.graph.nodes)

    def run_kept():
        with torch.no_grad():
            return kept(images[1], windows[1])

    calls = {"live": lambda: api.predict(model_b, images[1], windows[1], g_thresh["b"]),
             "loaded": lambda: run_here(images[1], windows[1]),
             "exported_with_asserts": run_kept}
    want = calls["live"]()
    for key in ("loaded", "exported_with_asserts"):
        need(all(torch.equal(g, w) for g, w in zip(calls[key](), want)),
             f"deploy_b1 {key} in this process differs from the live predict")
    here = {key: [] for key in calls}
    for _ in range(2):
        for key, fn in calls.items():
            here[key].append(cuda_ms(torch, fn, 20))
    here_profiles = {key: profile_window(torch, fn, 5, here[key][-1], host_ops=True)
                     for key, fn in calls.items()}
    # cli infer over a longer folder: the val images copied INFER_REPEATS times
    rep_dir = os.path.join(root, "infer_timing_images")
    os.makedirs(rep_dir)
    names = sorted(os.listdir(cmd["val_dir"]))
    for r in range(INFER_REPEATS):
        for name in names:
            shutil.copy(os.path.join(cmd["val_dir"], name),
                        os.path.join(rep_dir, f"r{r}_{name}"))
    infer = {}
    for route, extra in (("checkpoint", ["--checkpoint", cmd["checkpoint"],
                                         "--threshold", repr(cmd["threshold"])]),
                         ("artifact", ["--artifact", cmd["artifact"]])):
        out, wall_s = run_cli(["infer", "--images", rep_dir, "--out",
                               os.path.join(root, f"infer_timing_{route}")]
                              + extra + cmd["common"])
        ms = [float(x.group(4)) for x in map(INFER_LINE.match, out.splitlines()) if x]
        need(len(ms) == len(names) * INFER_REPEATS, f"infer {route}: {len(ms)} lines")
        # the first image pays the first call's set-up
        steady = sorted(ms[1:])
        infer[route] = {"images": len(ms), "first_ms": ms[0],
                        "median_ms": steady[len(steady) // 2],
                        "p90_ms": steady[int(0.9 * (len(steady) - 1))],
                        "min_ms": steady[0], "max_ms": steady[-1], "wall_s": wall_s}
    return {"loaded_predict_ms": loaded, "live_predict_ms": live,
            "deploy_b1_here_ms": here, "deploy_b1_here_profiles": here_profiles,
            "assert_nodes_dropped": n_asserts, "infer_ms_per_image": infer,
            "worker_wall_s": wall, "worker_device": report["device"]}


def nms_case(torch, gen, b, k):
    """Score-sorted candidates: clustered overlapping boxes, 3 classes,
    scores rounded to 1/32 (forced ties)."""
    centers = torch.rand((b, 12, 2), generator=gen) * 0.7 + 0.15
    pick = torch.randint(0, 12, (b, k), generator=gen)
    lo = (torch.gather(centers, 1, pick[..., None].expand(-1, -1, 2))
          + (torch.rand((b, k, 2), generator=gen) - 0.5) * 0.08 - 0.08)
    hw = torch.rand((b, k, 2), generator=gen) * 0.1 + 0.1
    boxes = torch.cat([lo, lo + hw], -1).clamp(0, 1)
    scores = torch.round(torch.rand((b, k), generator=gen) * 32) / 32
    scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    classes = torch.randint(0, 3, (b, k), generator=gen, dtype=torch.int32)
    valid = scores > 0.2
    return [t.contiguous().cuda() for t in (boxes, scores, classes, valid)]


def nms_knife_edge(torch, np):
    """Box pairs in disjoint bands whose IoU lies within a few ulps of 0.3:
    some second boxes must survive while others are suppressed."""
    w = [np.float32(0.3)]
    for step in (np.float32(1), np.float32(0)):
        x = np.float32(0.3)
        for _ in range(8):
            x = np.nextafter(x, step)
            w.append(x)
    h = 1.0 / 64
    boxes, scores = [], []
    for i, wi in enumerate(sorted(w)):
        y0 = 2 * i * h
        boxes += [[y0, 0.0, y0 + h, 1.0], [y0, 0.0, y0 + h, float(wi)]]
        scores += [1.0 - i / 64, 1.0 - i / 64 - 1 / 128]
    k = len(scores)
    return [torch.tensor([boxes], dtype=torch.float32).cuda(),
            torch.tensor([scores], dtype=torch.float32).cuda(),
            torch.zeros((1, k), dtype=torch.int32).cuda(),
            torch.ones((1, k), dtype=torch.bool).cuda()]


# what phase 2 checks and phase 4 sweeps through the kernels' config entry
# points: K2 with its sorted route allowed or the general route forced;
# K1's launch shape, threads per block and rows per thread
K2_ROUTES = (0, 1)
K1_CONFIGS = [(threads, rows) for threads in (128, 256, 512, 1024)
              for rows in (1, 2, 4)]


def config_entries(_build):
    """The kernels' C entry points that take a launch shape:
    ``dis_nms_config`` and ``dis_assemble_masks_config``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entries = {}
    for name, symbol, argtypes in (
            ("nms", "dis_nms_config", [p, p, p, p, p, i, i, i, f, i, p]),
            ("assembly", "dis_assemble_masks_config",
             [p, p, p, i, i, i, i, i, i, i, i, i, p])):
        fn = getattr(ctypes.CDLL(str(_build.build([name])[name])), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    return entries


def nms_config(torch, fn, case, max_det, thr, general):
    """K2 through ``dis_nms_config``, the general route forced if
    ``general`` (no launch counted)."""
    boxes, scores, classes, valid = case
    out = torch.empty((scores.shape[0], max_det), dtype=torch.int64, device="cuda")
    err = fn(boxes.data_ptr(), scores.data_ptr(), classes.data_ptr(),
             valid.data_ptr(), out.data_ptr(), scores.shape[0], scores.shape[1],
             max_det, thr, general, torch.cuda.current_stream().cuda_stream)
    need(err == 0, f"dis_nms_config(general={general}): CUDA error {err}")
    return out


def assembly_config(torch, fn, sm, boxes, k, launch, apply_sigmoid=True,
                    pixel_boxes=False, planes=False):
    """K1 through ``dis_assemble_masks_config`` with ``launch`` = (threads,
    rows per thread) (no launch counted)."""
    s = sm.shape[2]
    out = torch.empty((sm.shape[0], boxes.shape[1], s, s), device="cuda")
    err = fn(sm.data_ptr(), boxes.data_ptr(), out.data_ptr(), sm.shape[0],
             boxes.shape[1], s, k, int(apply_sigmoid), int(pixel_boxes),
             int(planes), *launch, torch.cuda.current_stream().cuda_stream)
    need(err == 0, f"dis_assemble_masks_config{launch}: CUDA error {err}")
    return out


def check_nms(torch, nms, custom_ops, nms_fn, case, max_det, tag, min_kept=0,
              none_in=()):
    """K2 index-exact against its plain version on the card and on the CPU,
    by its default route and with the general route forced; images
    ``none_in`` must keep nothing.  Returns the picks and their max |diff|
    from the plain version's."""
    got = custom_ops.nms_cuda(*case, max_det, 0.3)
    want = nms._select_suppress_nms(*case, 0.3, max_det)
    want_cpu = nms._select_suppress_nms(*(t.cpu() for t in case), 0.3, max_det)
    torch.cuda.synchronize()
    need(torch.equal(got, want), f"K2 {tag} not index-exact:\n{got}\n{want}")
    need(torch.equal(want.cpu(), want_cpu), f"K2 {tag}: plain differs card vs CPU")
    for general in K2_ROUTES:
        need(torch.equal(nms_config(torch, nms_fn, case, max_det, 0.3, general), want),
             f"K2 {tag} not index-exact with general={general}")
    kept = int((got >= 0).sum())
    need(kept >= min_kept, f"K2 {tag} kept too few boxes: {kept}")
    for i in none_in:
        need(bool((got[i] == -1).all()), f"K2 {tag}: image {i} kept {got[i]}")
    print(f"K2 {tag}: index-exact by both routes, {kept} kept", flush=True)
    return got, float((got - want).abs().max())


def edge_boxes(torch, gen, b, d, s):
    """``random_boxes`` with, in every image, the whole map, a box touching
    the bottom and right edges (y2 = x2 = S), two 1-pixel boxes (one the
    last pixel), an inverted box, a box past the map's edges, and three
    zero (padding) rows."""
    boxes = random_boxes(torch, gen, b, d, 3)
    r, c = (int(v) for v in torch.randint(0, s, (2,), generator=gen))
    boxes[:, 4:10] = torch.tensor(
        [[0, 0, 1, 1], [0.5, 0.25, 1, 1], [r / s, c / s, (r + 1) / s, (c + 1) / s],
         [(s - 1) / s, (s - 1) / s, 1, 1], [0.7, 0.2, 0.2, 0.9],
         [-0.1, 0.3, 0.4, 1.2]])
    return boxes


def check_assembly_edges(torch, custom_ops, asm_fn, gen, b, s, k, d):
    """K1 in all three modes on ``edge_boxes``: normalized boxes on the
    NHWC map (logits bit-exact, sigmoid within 1e-6, in the default launch
    and in every swept shape), pixel boxes (the training forward) and
    channel planes (K4's layout) with either kind of box, all bit-exact
    against the plain version; the plain version on the card against the
    CPU's."""
    sm = torch.randn((b, s, s, k * k), generator=gen).cuda()
    bx = edge_boxes(torch, gen, b, d, s).cuda()
    px = torch.round(bx * s)
    planes = sm.permute(0, 3, 1, 2).contiguous()
    tag = f"S={s} B={b} D={d} k={k} edge boxes"
    want = custom_ops.assemble_masks_batch_plain(sm, bx, k, apply_sigmoid=False)
    need(torch.equal(want.cpu(), custom_ops.assemble_masks_batch_plain(
        sm.cpu(), bx.cpu(), k, apply_sigmoid=False)),
        f"K1 plain logits differ between card and CPU ({tag})")
    need(bool(want[:, 4].all()) and not bool(want[:, 8].any())
         and not bool(want[:, d - 3:].any()), f"K1 edge case not as built ({tag})")
    for name, got in (
            ("logits", custom_ops.assemble_masks_batch_cuda(sm, bx, k, False)),
            *((f"logits, launch {launch}", assembly_config(torch, asm_fn, sm, bx, k,
                                                           launch, False))
              for launch in K1_CONFIGS),
            ("planes logits", custom_ops.assemble_masks_batch_cuda(
                planes, bx, k, False, planes=True))):
        need(torch.equal(got, want), f"K1 {name} not bit-exact ({tag})")
    want_px = custom_ops.assemble_masks_batch_plain(sm, px, k, False, pixel_boxes=True)
    for name, got in (
            ("pixel-box logits", custom_ops.assemble_masks_batch_cuda(
                sm, px, k, False, pixel_boxes=True)),
            ("planes pixel-box logits", custom_ops.assemble_masks_batch_cuda(
                planes, px, k, False, pixel_boxes=True, planes=True))):
        need(torch.equal(got, want_px), f"K1 {name} not bit-exact ({tag})")
    got = custom_ops.assemble_masks_batch_cuda(sm, bx, k)
    probs = custom_ops.assemble_masks_batch_plain(sm, bx, k)
    torch.cuda.synchronize()
    need(torch.equal(got != 0, probs != 0), f"K1 support differs ({tag})")
    err = float((got - probs).abs().max())
    need(err <= 1e-6, f"K1 sigmoid error {err} > 1e-6 ({tag})")
    print(f"K1 {tag}: logits bit-exact in all three modes and every launch "
          f"shape, sigmoid max err {err:.3g}", flush=True)
    return err


# K5, the mask paste: the four serving shapes (mask size x photo size) at
# B=8, D=30 on a 576 input
PASTE_SHAPES = [(s, hw) for s in (288, 576) for hw in ((720, 960), (960, 720))]


def paste_dets(torch, gen, b, d, h0, w0, net, edges=False):
    """[b,d,6] detections (normalized letterboxed yxyx, class, score) on a
    ``h0`` x ``w0`` photo letterboxed to ``net``: random boxes inside the
    photo's window, classes 0-2, a fifth of the rows padding (score 0).
    ``edges`` puts in every image the whole window, boxes on its bottom
    and right edges, a 1-pixel box, an inverted box and six boxes of 1-3
    photo pixels a side (some crops round to no score-map pixel), classes
    255, 300 and -1, and in the last image only padding rows."""
    sc = min(net / h0, net / w0)
    nh, nw = int(h0 * sc), int(w0 * sc)
    oy, ox = (net - nh) // 2 / net, (net - nw) // 2 / net
    fy, fx = nh / net, nw / net
    u = torch.rand((b, d, 4), generator=gen)
    y = torch.sort(u[..., 0::2], -1).values * fy + oy
    x = torch.sort(u[..., 1::2], -1).values * fx + ox
    boxes = torch.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], -1)
    cls = torch.randint(0, 3, (b, d, 1), generator=gen).float()
    score = torch.rand((b, d, 1), generator=gen) * 0.9 + 0.05
    score[:, d - d // 5:] = 0.0
    if edges:
        r, c = (int(v) for v in torch.randint(1, min(h0, w0) - 4, (2,), generator=gen))
        py, px = fy / h0, fx / w0          # one photo pixel, normalized
        boxes[:, :6] = torch.tensor([
            [oy, ox, oy + fy, ox + fx],
            [oy + fy / 2, ox + fx / 3, oy + fy, ox + fx],
            [oy + r * py, ox + c * px, oy + (r + 1) * py, ox + (c + 1) * px],
            [oy + (h0 - 1) * py, ox, oy + fy, ox + 5 * px],
            [oy + 0.7 * fy, ox + 0.2 * fx, oy + 0.2 * fy, ox + 0.9 * fx],
            [oy, ox + (w0 - 1) * px, oy + fy, ox + fx]])
        # boxes of 1-3 photo pixels a side: at S=288 one photo pixel is a
        # third of a score-map pixel, so some crops round to no pixel
        lo = torch.rand((b, 6, 2), generator=gen) * 0.9
        side = torch.randint(1, 4, (b, 6, 2), generator=gen).float()
        boxes[:, 6:12] = torch.stack([
            oy + lo[..., 0] * fy, ox + lo[..., 1] * fx,
            oy + lo[..., 0] * fy + side[..., 0] * py,
            ox + lo[..., 1] * fx + side[..., 1] * px], -1)
        cls[:, :3, 0] = torch.tensor([255.0, 300.0, -1.0])
        score[:, :12] = 0.9
        score[-1] = 0.0
    return torch.cat([boxes, cls, score], -1)


def paste_case(torch, custom_ops, gen, b, d, s, h0, w0, net=576, edges=False):
    """(masks, dets) as the serving path makes them: K1's sigmoid masks of
    random k=3 score maps at the detections' boxes."""
    dets = paste_dets(torch, gen, b, d, h0, w0, net, edges).cuda()
    sm = torch.randn((b, s, s, 9), generator=gen).cuda()
    return custom_ops.assemble_masks_batch_cuda(sm, dets[..., :4].contiguous(), 3), dets


def check_paste(torch, paste, custom_ops, profiling, gen, s, h0, w0, b=8, d=30,
                seeds=1, edges=False, timed=False):
    """K5 against the dense route (cuBLAS's float32 products) on the card,
    exactly: the pasted masks, the validity flags and the semantic map of
    ``paste.paste_masks_batch`` (one K5 launch a call, no tap matrix
    built) and the masks of ``paste_masks_single``, over ``seeds`` cases.
    The record's ``max_abs_err`` is the largest difference of any
    compared value.  With ``timed``, K5's device time by CUDA-graph
    replays beside its bound (the bytes it has to move: all D rows'
    booleans and the semantic map written, each valid box's rounded crop
    of the mask read) and the dense route's."""
    tag = f"S={s} {h0}x{w0} B={b} D={d}" + (" edge boxes" if edges else "")
    dense_matrix = paste._axis_matrix
    err = 0
    for _ in range(seeds):
        masks, dets = paste_case(torch, custom_ops, gen, b, d, s, h0, w0,
                                 edges=edges)
        valid, taps = paste.paste_taps(dets, s, h0, w0, 576)
        cls = torch.clamp(dets[..., 4].to(torch.int32), 0, 255)
        want, want_sem = paste.paste_masks_plain(masks, taps, valid, cls,
                                                 h0, w0, True)
        before = profiling.counters().get("kernel.k5", 0)
        paste._axis_matrix = lambda *a: fail(
            f"K5 {tag}: the CUDA route built a tap matrix")
        try:
            full, valid_k5, sem = paste.paste_masks_batch(masks, dets, h0, w0, 576)
            single, _ = paste.paste_masks_single(masks, dets, h0, w0, 576)
        finally:
            paste._axis_matrix = dense_matrix
        torch.cuda.synchronize()
        need(profiling.counters().get("kernel.k5", 0) - before == 2,
             f"K5 {tag}: not one launch a call")
        need(bool(want.any()) or edges, f"K5 {tag}: nothing pasted")
        for name, got, ref in (("masks", full, want), ("valid", valid_k5, valid),
                               ("semantic map", sem, want_sem),
                               ("single masks", single, want)):
            need(torch.equal(got, ref), f"K5 {name} not exact ({tag}): "
                 f"{int((got != ref).sum())} of {ref.numel()} differ")
            err = max(err, int((got != ref).any()) if got.dtype == torch.bool
                      else int((got.int() - ref.int()).abs().max()))
    # valid rows whose crop rounds to no score-map pixel on some axis, and
    # pixels painted by detection 0 (class 255, painted as 0)
    no_crop = int((valid & ~(paste.axis_tables(taps, 0, h0)[3].any(-1)
                             & paste.axis_tables(taps, 1, w0)[3].any(-1))).sum())
    order = torch.arange(1, d + 1, dtype=torch.uint8,
                         device=want.device)[None, :, None, None]
    class255 = int(((want.to(torch.uint8) * order).amax(1) == 1).sum())
    if edges:
        need(not bool(valid[-1].any()) and not bool(full[-1].any())
             and not bool(sem[-1].any()), f"K5 {tag}: padding image pasted")
        need(class255 > 0 and (no_crop > 0 or s != 288),
             f"K5 {tag}: edge cases missing: {class255} class-255 pixels, "
             f"{no_crop} valid rows with no crop")
    rec = {"shape": tag, "seeds": seeds, "pixels_set": int(want.sum()),
           "valid_rows": int(valid.sum()), "valid_rows_no_crop": no_crop,
           "class255_pixels": class255, "max_abs_err": err}
    if timed:
        boxes = paste.correct_boxes_device(dets[..., :4], h0, w0, 576, 576)
        crop = torch.round(dets[..., :4] * s).clamp(0, s)
        crop_px = ((crop[..., 2] - crop[..., 0]).clamp_min(0)
                   * (crop[..., 3] - crop[..., 1]).clamp_min(0) * valid)
        nbytes = b * d * h0 * w0 + b * h0 * w0 + 4 * int(crop_px.sum())
        inside = int(((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
                      * valid).sum())
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 8 * inside)
        rec["k5_ms"] = graph_ms(torch, lambda: custom_ops.paste_masks_cuda(
            masks, taps, valid, cls, h0, w0, True))
        rec["dense_ms"] = graph_ms(torch, lambda: paste.paste_masks_plain(
            masks, taps, valid, cls, h0, w0, True), n=2, reps=5)
    print(f"K5 {tag}: masks, valid and semantic map exact against the dense "
          f"route over {seeds} case(s); "
          + json.dumps({k: v for k, v in rec.items() if k != "shape"}), flush=True)
    return rec


# ---------------------------------------------------------------------------
# the data-parallel phase (after the device-data phase): ranks in worker
# processes (``chip_smoke.py --dp-worker SPEC``), each on its card

DP_GLOBAL_BATCH = 4     # two rows per rank
DP_STEPS = 3
DP_SEED = 7
SP_BATCH = 2            # the spatial step's global batch (dp = 1)
SP_REPEATS = 5          # timed spatial predicts after the first
# the int8 graph's accumulator probes: its first quantized 3x3 layer
# (stride 2, a halo row below) and its first of stride 1 (one each side)
SP_INT8_PROBES = ("convolutional5", "convolutional7")


def parallel_modules():
    """The data-parallel layer and what it drives, as one namespace."""
    from dis_yolo_tpu_torch.config import DISYoloConfig
    from dis_yolo_tpu_torch.data.val_data import DefectValData
    from dis_yolo_tpu_torch.eval.map_eval import Evaluator
    from dis_yolo_tpu_torch.eval.sweep import run_split
    from dis_yolo_tpu_torch.models import api, fold, layers, quant
    from dis_yolo_tpu_torch.ops import cuda_assembly, custom_ops
    from dis_yolo_tpu_torch.parallel import distributed, sharding, spatial
    from dis_yolo_tpu_torch.train import train_step as ts
    from dis_yolo_tpu_torch.train.synthetic import synthetic_batch
    from dis_yolo_tpu_torch.utils import profiling
    from dis_yolo_tpu_torch.utils.runtime import calibrate_threshold
    return types.SimpleNamespace(**locals())


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_batches(np, m, size):
    """The DP_STEPS global batches (wire format) every rank and the
    one-process reference train on."""
    cfg = m.DISYoloConfig(image_size=size, batch_size=DP_GLOBAL_BATCH)
    return [wire_batch(np, m.synthetic_batch, cfg, seed=s) for s in range(DP_STEPS)]


def dp_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def state_digest(torch, model, opt) -> str:
    """sha256 over every tensor of the model's state and Adam's moments."""
    import hashlib
    h = hashlib.sha256()
    tensors = (list(model.state_dict().values()) + list(opt.mu.values())
               + list(opt.nu.values()))
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def param_sample(np, torch, model, n=4096):
    """Each parameter's values at ``n`` fixed positions (all of a smaller
    one), float64 numpy, for comparing runs in two processes."""
    out = {}
    for k, p in model.named_parameters():
        flat = p.detach().double().reshape(-1)
        if flat.numel() > n:
            pos = np.random.RandomState(flat.numel() % 2**31).randint(
                0, flat.numel(), n)
            flat = flat[torch.from_numpy(pos).to(flat.device)]
        out[k] = flat.cpu().numpy()
    return out


def dp_train(np, torch, m, mesh, dev, batches, size):
    """DP_STEPS float32 stage-2 steps (TF32 off) from the seed-7 weights on
    this rank's rows of ``batches``, then DP_STEPS bf16 steps of the
    default config (stage 1).  The mesh may be None: the one-process
    reference on the whole batches.  Returns (record, parameter samples
    after the first and after the last float32 step)."""
    rec = {}
    for tag, cfg in (("f32_stage2", m.DISYoloConfig(
            image_size=size, compute_dtype="float32", locked_layers=())),
                     ("bf16_default", m.DISYoloConfig(image_size=size))):
        model = m.api.init_model(cfg, DP_SEED, device=dev)
        state = m.ts.init_train_state(model, device=dev, mesh=mesh)
        step = m.ts.make_train_step(model, device=dev, mesh=mesh)
        gen = torch.Generator().manual_seed(11)
        m.profiling.reset_counters()
        losses, walls = [], []
        for b in batches:
            rows = b if mesh is None else m.sharding.shard_batch(mesh, b)
            dp_sync(torch, dev)
            t0 = time.perf_counter()
            _, metrics = step(state, rows, gen)
            losses.append(float(metrics["total_loss"]))   # synchronizes
            walls.append(time.perf_counter() - t0)
            if tag == "f32_stage2" and len(losses) == 1:
                sample = {f"step1:{k}": v for k, v in
                          param_sample(np, torch, model).items()}
        rec[tag] = {"losses": losses, "step_wall_s": walls,
                    "launches": kernel_launches(m.profiling, "K1", "K3"),
                    "digest": state_digest(torch, model, state.opt)}
        if tag == "f32_stage2":
            sample.update({f"last:{k}": v for k, v in
                           param_sample(np, torch, model).items()})
            n_packed = sum(p.numel() for p in model.parameters()) + len(metrics)
        del model, state, step
    if mesh is not None:
        # the step's one packed all-reduce, alone, at the size it sends
        buf = torch.ones(n_packed, device=dev)
        m.distributed.all_reduce_mean_(buf, mesh)
        times = []
        for _ in range(5):
            dp_sync(torch, dev)
            t0 = time.perf_counter()
            m.distributed.all_reduce_mean_(buf, mesh)
            dp_sync(torch, dev)
            times.append((time.perf_counter() - t0) * 1e3)
        rec["packed_all_reduce"] = {"floats": n_packed, "bytes": 4 * n_packed,
                                    "ms": times}
        del buf
    return rec, sample


def dp_sweep(np, torch, m, mesh, dev, root, thresh, size):
    """The seed-7 bf16 model swept over the Solver split's val images by
    the host and device_score routes (``run_split``, deterministic
    algorithms), on ``mesh`` at the global batch, or in one process at
    a rank's batch (the same images in each batch).  Returns per route
    the boxes [N,D,6], the mAP and the K5 launches (the device_score
    route pastes on the card)."""
    b = DP_GLOBAL_BATCH if mesh is not None else DP_GLOBAL_BATCH // 2
    cfg = m.DISYoloConfig(dataset=root, image_size=size, test_size=size,
                          batch_size=b, obj_threshold=thresh)
    model = m.api.init_model(cfg, DP_SEED, device=dev)
    ev = m.Evaluator(cfg, "val")
    images, names, windows = m.DefectValData(cfg, "val").get()
    out = {}
    with deterministic(torch):
        for route in ("host", "device_score"):
            k5_before = kernel_launches(m.profiling, "K5")["K5"]
            det, t = m.run_split(cfg, model, images, names, windows, mesh=mesh,
                                 device=dev, gt_sizes=ev.gt_sizes,
                                 gt_records=ev.gt_masks, want_semantic=False,
                                 device_score=route == "device_score")
            res = ev.evaluate_detections(det)
            out[route] = {"boxes": np.stack([d["boxes"] for d in det]),
                          "mAP": float(res["mAP"]), "predict_s": t,
                          "launches_K5": kernel_launches(m.profiling, "K5")["K5"]
                          - k5_before}
    return out


@contextlib.contextmanager
def counting_exchanges(m, sent):
    """While it runs, ``sent`` counts the calls of
    ``parallel.distributed.gather_exact`` (the halo exchanges and the
    gathers of the raw outputs) and the bytes this rank puts in them (its
    slot of each all-reduce; the all-reduce moves that times the ranks)."""
    real = m.distributed.gather_exact

    def count(t, mesh):
        sent["calls"] += 1
        sent["bytes"] += t.numel() * t.element_size()
        return real(t, mesh)
    m.distributed.gather_exact = count
    try:
        yield sent
    finally:
        m.distributed.gather_exact = real


def peak_reset(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(torch, dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def sp_timed(torch, m, dev, run, img, win):
    """The first call of ``run(img, win)`` with its exchanges counted
    (``counting_exchanges``) and the peak memory over it, then
    SP_REPEATS timed calls: (detections, record)."""
    peak_reset(torch, dev)
    with counting_exchanges(m, {"calls": 0, "bytes": 0}) as sent:
        dets, _ = run(img, win)
    ms = []
    for _ in range(SP_REPEATS):
        dp_sync(torch, dev)
        t0 = time.perf_counter()
        run(img, win)
        dp_sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    dets = dets.cpu().numpy()
    return dets, {"ms": ms, "peak_bytes": peak_bytes(torch, dev),
                  "exchanged_per_predict": sent,
                  "kept": int((dets[..., 5] > 0).sum())}


def sp_int8(np, torch, m, mesh, dev, root, cfg, img, win, images, int8):
    """The default int8 graph (layers 5-85, absmax calibration, as
    ``build_graphs``) on the seed-7 weights: predict of ``img`` timed as
    ``sp_timed``, and each SP_INT8_PROBES layer's int32 accumulator.  In
    one process (mesh None) it calibrates on ``img``, takes the int8
    graph's threshold (``calibrate_threshold`` on ``images``) and saves
    each probe layer's input, as predict gave it, under ``root``; a rank
    takes ``int8`` (that calibration, threshold and file) and runs each
    probe layer, height-sharded, on its rows of the saved input.
    Returns (record, arrays, the ``int8`` spec for the ranks)."""
    qcfg = cfg.replace(quant=True)
    dsd = m.fold.deploy_variables(
        m.api.init_model(cfg, DP_SEED, device=dev).state_dict())
    if int8 is None:
        absmax = m.quant.calibrate_deploy(m.api.create_model(
            cfg.replace(quant=True, quant_calibrate=True), device=dev), dsd, img)
    else:
        absmax = int8["absmax"]
    model = m.api.create_model(qcfg, device=dev)
    model.load_state_dict(m.quant.quantize_deploy(dsd, absmax))
    del dsd
    if int8 is None:
        thresh = m.calibrate_threshold(model, images[:2], qcfg)
        inputs = {}
        hooks = [getattr(model, name).register_forward_pre_hook(
            lambda mod, args, _n=name: inputs.setdefault(_n, args[0].detach()))
            for name in SP_INT8_PROBES]
        m.api.predict(model, img, win, thresh, device=dev)
        for h in hooks:
            h.remove()
        probe = os.path.join(root, "sp_int8_probe.pt")
        torch.save({k: v.cpu() for k, v in inputs.items()}, probe)
        int8 = {"absmax": absmax, "threshold": thresh, "probe": probe}
    thresh = int8["threshold"]
    run = (lambda i, w: m.api.predict(model, i, w, thresh, device=dev)) \
        if mesh is None else m.spatial.spatial_predict(model, mesh, thresh)
    k1_before = kernel_launches(m.profiling, "K1")["K1"]
    dets, rec = sp_timed(torch, m, dev, run, img, win)
    rec.update(launches_K1=kernel_launches(m.profiling, "K1")["K1"] - k1_before,
               threshold=thresh)
    arrays = {"dets_int8": dets}
    saved = torch.load(int8["probe"])
    with torch.no_grad():
        for name in SP_INT8_PROBES:
            layer, x = getattr(model, name), saved[name].to(dev)
            if mesh is None:
                acc, rows = layer.accumulate(x), None
            else:
                with m.layers.height_sharded(model, mesh, (cfg.image_size,) * 2) as sh:
                    a, b = sh.ranges(x.shape[3])[1][mesh.sp.rank]
                    acc = layer.accumulate(x[:, :, a:b])
                    rows = sh.ranges(acc.shape[2])[1][mesh.sp.rank]
            arrays[f"probe_acc:{name}"] = acc.cpu().numpy()
            if rows is not None:
                arrays[f"probe_rows:{name}"] = np.asarray(rows)
    del model, run, saved
    return rec, arrays, int8


def sp_steps(np, torch, m, mesh, dev, cfg, size):
    """DP_STEPS float32 stage-2 steps at B=SP_BATCH (the first rows of the
    DP batches) without ``remat`` and then with it, each from the seed-7
    weights under deterministic algorithms (so the two can be equal to
    the bit): per run every step's metrics and wall, the peak memory
    (also above what was allocated before the model), the state's digest
    and K3's launches."""
    batches = [{k: v[:SP_BATCH] for k, v in b.items()}
               for b in dp_batches(np, m, size)]
    out = {}
    for remat in (False, True):
        dp_sync(torch, dev)
        before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
        model = m.api.init_model(cfg.replace(compute_dtype="float32",
                                             locked_layers=(), remat=remat),
                                 DP_SEED, device=dev)
        state = m.ts.init_train_state(model, device=dev, mesh=mesh)
        step = m.ts.make_train_step(model, device=dev) if mesh is None \
            else m.spatial.spatial_train_step(model, mesh)
        gen = torch.Generator().manual_seed(11)
        rows, walls = [], []
        k3_before = kernel_launches(m.profiling, "K3")["K3"]
        peak_reset(torch, dev)
        with deterministic(torch):
            for b in batches:
                dp_sync(torch, dev)
                t0 = time.perf_counter()
                state, metrics = step(state, b, gen)
                rows.append({k: float(v) for k, v in metrics.items()})  # syncs
                walls.append(time.perf_counter() - t0)
        peak = peak_bytes(torch, dev)
        out["step_remat" if remat else "step_f32_stage2"] = {
            "losses": [r["total_loss"] for r in rows], "metrics": rows,
            "step_wall_s": walls, "peak_bytes": peak,
            "peak_above_before_bytes": None if peak is None else peak - before,
            "digest": state_digest(torch, model, state.opt),
            "launches_K3": kernel_launches(m.profiling, "K3")["K3"] - k3_before}
        del model, state, step, metrics
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def sp_run(np, torch, m, mesh, dev, root, thresh, size, int8=None):
    """The spatial checks' run: predict of the Solver split's first val
    image (B=1, at the threshold that fills the detection slots) with the
    seed-7 weights in float32, in bf16 and in the int8 graph
    (``sp_int8``), SP_REPEATS timed calls after the first, then the
    float32 stage-2 steps with and without ``remat`` (``sp_steps``) --
    through ``parallel.spatial`` on ``mesh`` (a Mesh2D), or in one
    process (mesh None), their reference.  Returns (record, arrays, the
    int8 spec for the ranks), with K1's and K3's launches over the
    run."""
    cfg = m.DISYoloConfig(dataset=root, image_size=size, test_size=size)
    images, _, windows = m.DefectValData(cfg, "val").get()
    img, win = images[:1], windows[:1]
    rec, arrays = {}, {}
    m.profiling.reset_counters()
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        model = m.api.init_model(cfg.replace(compute_dtype=dtype), DP_SEED,
                                 device=dev)
        run = (lambda i, w: m.api.predict(model, i, w, thresh, device=dev)) \
            if mesh is None else m.spatial.spatial_predict(model, mesh, thresh)
        arrays[f"dets_{tag}"], rec[f"predict_{tag}"] = sp_timed(
            torch, m, dev, run, img, win)
        del model, run
    rec["predict_int8"], int8_arrays, int8 = sp_int8(
        np, torch, m, mesh, dev, root, cfg, img, win, images, int8)
    arrays.update(int8_arrays)
    rec.update(sp_steps(np, torch, m, mesh, dev, cfg, size))
    rec["launches"] = kernel_launches(m.profiling, "K1", "K3")
    return rec, arrays, int8


def sp_compare(np, results, ref_rec, ref_arrays):
    """The sp = 2 ranks against each other and against one process: the
    float32 predict's keep set row for row (classes equal, boxes and
    scores within rtol 1e-5, ``tests/test_parallel.py``'s), the bf16
    kept count within 2, the step-1 loss within rel 1e-4, the replicas
    bit-equal after DP_STEPS steps, every loss finite, K1 and K3
    launched in each rank; the int8 graph (``sp_int8_compare``) and the
    remat step (``sp_remat_compare``).  Returns the comparison record."""
    recs = [r["spatial"] for r, _ in results]
    want = ref_arrays["dets_f32"]
    for (r, arrays), sp in zip(results, recs):
        got = arrays["sp:dets_f32"]
        need(np.array_equal(got[..., 5] > 0, want[..., 5] > 0)
             and np.array_equal(got[..., 4], want[..., 4])
             and np.allclose(got[..., :4], want[..., :4], rtol=1e-5, atol=1e-6)
             and np.allclose(got[..., 5], want[..., 5], rtol=1e-5, atol=1e-7),
             f"spatial predict f32 rank {r['rank']}: not one process's keep set "
             f"(kept {sp['predict_f32']['kept']} vs "
             f"{ref_rec['predict_f32']['kept']}, max |diff| "
             f"{float(np.abs(got - want).max())})")
        need(np.array_equal(got, results[0][1]["sp:dets_f32"]),
             f"spatial predict f32 rank {r['rank']}: differs from rank 0's")
        need(abs(sp["predict_bf16"]["kept"] - ref_rec["predict_bf16"]["kept"]) <= 2,
             f"spatial predict bf16 rank {r['rank']}: kept "
             f"{sp['predict_bf16']['kept']} vs {ref_rec['predict_bf16']['kept']}")
        need(np.isfinite(sp["step_f32_stage2"]["losses"]).all(),
             f"spatial step rank {r['rank']}: {sp['step_f32_stage2']['losses']}")
        need(r["device"] == "cpu" or (sp["launches"]["K1"] > 0
                                      and sp["launches"]["K3"] > 0),
             f"spatial rank {r['rank']}: K1/K3 never launched: {sp['launches']}")
    need(len({sp["step_f32_stage2"]["digest"] for sp in recs}) == 1,
         "spatial step: the ranks' replicas differ")
    got, want = (x["step_f32_stage2"]["losses"][0] for x in (recs[0], ref_rec))
    rel = abs(got - want) / abs(want)
    need(rel <= 1e-4, f"spatial step: step-1 loss {got} against one "
         f"process's {want} (rel {rel})")
    return {"step1_loss_rel": rel,
            "int8_predict": sp_int8_compare(np, results, ref_rec, ref_arrays),
            "remat_step": sp_remat_compare(np, results, ref_rec),
            "losses_f32": recs[0]["step_f32_stage2"]["losses"],
            "losses_one_process_f32": ref_rec["step_f32_stage2"]["losses"],
            "kept_f32": ref_rec["predict_f32"]["kept"],
            "kept_bf16": [sp["predict_bf16"]["kept"] for sp in recs]
            + [ref_rec["predict_bf16"]["kept"]],
            "one_process": ref_rec, "ranks": recs}


def sp_int8_compare(np, results, ref_rec, ref_arrays):
    """The int8 graph on the sp = 2 ranks: the same detections on every
    rank, the kept count within 2 of one process's and the top 5 scores
    within rtol 1e-2 (the bf16 rule), each probe layer's int32
    accumulator rows equal to one process's to the bit (the same input),
    K1 launched in each rank's int8 predict.  Returns its record."""
    want = ref_arrays["dets_int8"]
    kept_want = ref_rec["predict_int8"]["kept"]
    for r, arrays in results:
        sp, tag = r["spatial"], f"spatial int8 predict rank {r['rank']}"
        got = arrays["sp:dets_int8"]
        need(np.array_equal(got, results[0][1]["sp:dets_int8"]),
             f"{tag}: differs from rank 0's")
        kept = sp["predict_int8"]["kept"]
        need(kept_want > 0 and abs(kept - kept_want) <= 2,
             f"{tag}: kept {kept} vs one process's {kept_want}")
        k = min(5, kept, kept_want)
        top = lambda d: np.sort(d[0, :, 5])[::-1][:k]
        need(np.allclose(top(got), top(want), rtol=1e-2, atol=3e-3),
             f"{tag}: top scores {top(got)} vs {top(want)}")
        for name in SP_INT8_PROBES:
            a, b = arrays[f"sp:probe_rows:{name}"]
            acc = arrays[f"sp:probe_acc:{name}"]
            ref = ref_arrays[f"probe_acc:{name}"][:, a:b]
            need(acc.dtype == np.int32 and acc.shape == ref.shape
                 and np.array_equal(acc, ref),
                 f"{tag}: {name}'s accumulator rows {a}:{b} differ from one "
                 f"process's ({int((acc != ref).sum()) if acc.shape == ref.shape else acc.shape})")
        need(r["device"] == "cpu" or sp["predict_int8"]["launches_K1"] > 0,
             f"{tag}: K1 never launched")
    ranks = [r["spatial"]["predict_int8"] for r, _ in results]
    return {"kept": [x["kept"] for x in ranks], "kept_one_process": kept_want,
            "threshold": ref_rec["predict_int8"]["threshold"],
            "ms_per_rank": [x["ms"] for x in ranks],
            "ms_one_process": ref_rec["predict_int8"]["ms"],
            "exchanged_per_predict": [x["exchanged_per_predict"] for x in ranks],
            "peak_bytes": [x["peak_bytes"] for x in ranks],
            "peak_bytes_one_process": ref_rec["predict_int8"]["peak_bytes"],
            "launches_K1": [x["launches_K1"] for x in ranks],
            "probe_layers_bit_equal": list(SP_INT8_PROBES)}


def sp_remat_compare(np, results, ref_rec):
    """The float32 stage-2 spatial step with ``remat`` against the one
    without, in each sp = 2 rank: every step's metrics equal, the state
    (parameters, BN statistics, Adam's moments) bit-equal, on every rank
    alike, the peak memory below the plain step's, K3 launched.  Returns
    its record."""
    for r, _ in results:
        sp, tag = r["spatial"], f"spatial remat step rank {r['rank']}"
        plain, remat = sp["step_f32_stage2"], sp["step_remat"]
        need(remat["metrics"] == plain["metrics"],
             f"{tag}: metrics {remat['metrics']} vs {plain['metrics']}")
        need(remat["digest"] == plain["digest"],
             f"{tag}: the state differs from the plain step's")
        need(r["device"] == "cpu" or remat["peak_bytes"] < plain["peak_bytes"],
             f"{tag}: peak {remat['peak_bytes']} not below {plain['peak_bytes']}")
        need(r["device"] == "cpu" or remat["launches_K3"] > 0,
             f"{tag}: K3 never launched")
    out = {}
    for key in ("step_f32_stage2", "step_remat"):
        ranks = [r["spatial"][key] for r, _ in results]
        out["remat" if key == "step_remat" else "plain"] = {
            "step_wall_s": [x["step_wall_s"] for x in ranks],
            "peak_bytes": [x["peak_bytes"] for x in ranks],
            "peak_above_before_bytes": [x["peak_above_before_bytes"] for x in ranks],
            "launches_K3": [x["launches_K3"] for x in ranks],
            "one_process": {k: ref_rec[key][k] for k in
                            ("step_wall_s", "peak_bytes", "peak_above_before_bytes")}}
    out["losses"] = results[0][0]["spatial"]["step_remat"]["losses"]
    return out


def dp_worker(spec_path: str) -> None:
    """``chip_smoke.py --dp-worker SPEC``: one rank of a data-parallel
    run.  Joins the group of ``spec`` (its backend, world size and
    rank; its card is the rank modulo the card count), runs ``dp_train``
    and, with ``spec["sweep"]``, ``dp_sweep`` on its mesh, saves the
    parameter samples and the sweep's boxes to ``spec["out"]`` and prints
    one JSON line."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    m = parallel_modules()
    size = spec["size"]
    backend = m.distributed.initialize(spec["device"], backend=spec["backend"],
                                       init_method=spec["init"],
                                       world_size=spec["world"], rank=spec["rank"])
    try:
        mesh = m.sharding.make_mesh(spec["device"])
        dev = mesh.device
        rec, sample = dp_train(np, torch, m, mesh, dev, dp_batches(np, m, size),
                               size)
        arrays = {f"param:{k}": v for k, v in sample.items()}
        if spec["sweep"]:
            sweep = dp_sweep(np, torch, m, mesh, dev, spec["root"],
                             spec["threshold"], size)
            for route, r in sweep.items():
                arrays[f"boxes:{route}"] = r.pop("boxes")
            rec["sweep"] = sweep
            # the same ranks as a 1-D sp mesh: the height split between them
            sp_mesh = m.sharding.make_mesh_2d(1, mesh.size, spec["device"])
            rec["spatial"], sp_arrays, _ = sp_run(
                np, torch, m, sp_mesh, dev, spec["root"], spec["threshold"],
                size, spec["int8"])
            arrays.update({f"sp:{k}": v for k, v in sp_arrays.items()})
        np.savez(spec["out"], **arrays)
        rec.update(backend=backend, rank=mesh.rank, world=mesh.size,
                   device=str(dev), card=torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   jax_imported="jax" in sys.modules or "dis_yolo_tpu" in sys.modules)
    finally:
        m.distributed.shutdown()
    print(json.dumps(rec), flush=True)


def run_dp_workers(np, root, tag, backend, world, sweep, threshold, size,
                   device="cuda", timeout=600, int8=None):
    """Start ``world`` ranks of ``dp_worker`` together and wait for them
    (``int8``: ``sp_run``'s spec for the spatial int8 predict, with
    ``sweep``): [(record, arrays)] by rank, and the wall s."""
    init = f"tcp://127.0.0.1:{free_port()}"
    procs, specs = [], []
    t0 = time.time()
    for rank in range(world):
        spec = {"rank": rank, "world": world, "init": init, "backend": backend,
                "sweep": sweep, "threshold": threshold, "root": root,
                "size": size, "device": device, "int8": int8,
                "out": os.path.join(root, f"dp_{tag}_{rank}.npz")}
        path = os.path.join(root, f"dp_{tag}_{rank}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        specs.append(spec)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker", path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.time() - t0
    results = []
    for rank, (p, (out, err), spec) in enumerate(zip(procs, outs, specs)):
        need(p.returncode == 0, f"dp worker {tag} rank {rank} failed:\n"
             + out[-3000:] + err[-6000:])
        arrays = dict(np.load(spec["out"]))
        os.remove(spec["out"])
        results.append((json.loads(out.strip().splitlines()[-1]), arrays))
    return results, wall


def dp_compare_train(np, tag, results, ref_rec, ref_sample):
    """The ranks of a DP training run against each other (bit-equal
    replicas) and against the one-process run: step-1 loss within rel
    1e-4, parameters after step 1 within rtol 5e-2, atol 3e-3
    (``tests/test_parallel.py``'s DP tolerance after one step: an Adam
    update whose tiny gradient flips sign moves by 2 lr), every loss
    finite, K1 and K3 launched in each rank.  Returns the comparison
    record, with the largest parameter difference after the last step
    (where flips add up)."""
    recs = [r for r, _ in results]
    for part in ("f32_stage2", "bf16_default"):
        need(len({r[part]["digest"] for r in recs}) == 1,
             f"{tag} {part}: the ranks' replicas differ")
        need(all(np.isfinite(r[part]["losses"]).all() for r in recs),
             f"{tag} {part}: a loss is not finite: {[r[part]['losses'] for r in recs]}")
        for r in recs:
            # on the CPU (a rehearsal) the plain versions run: no launch
            need(r["device"] == "cpu" or (r[part]["launches"]["K1"] > 0
                                          and r[part]["launches"]["K3"] > 0),
                 f"{tag} {part} rank {r['rank']}: K1/K3 never launched: "
                 f"{r[part]['launches']}")
    want = ref_rec["f32_stage2"]["losses"][0]
    rel = abs(recs[0]["f32_stage2"]["losses"][0] - want) / abs(want)
    need(rel <= 1e-4, f"{tag}: step-1 loss {recs[0]['f32_stage2']['losses'][0]} "
         f"against one process's {want} (rel {rel})")
    worst, last = -np.inf, 0.0
    for k, w in ref_sample.items():
        g = results[0][1][f"param:{k}"]
        if k.startswith("step1:"):
            excess = np.abs(g - w) - (3e-3 + 5e-2 * np.abs(w))
            worst = max(worst, float(excess.max()))
        else:
            last = max(last, float(np.abs(g - w).max()))
    need(worst <= 0, f"{tag}: step-1 parameters off the one-process run's "
         f"beyond rtol 5e-2, atol 3e-3 (worst excess {worst})")
    return {"step1_loss_rel": rel, "step1_param_worst_excess": worst,
            f"step{DP_STEPS}_param_max_abs_diff": last,
            "losses_f32": recs[0]["f32_stage2"]["losses"],
            "losses_one_process_f32": ref_rec["f32_stage2"]["losses"]}


def dp_world1_nccl(np, torch, m, batches, size):
    """World size 1 over NCCL: DP_STEPS float32 stage-2 steps on the mesh
    equal the steps without one bit for bit (deterministic algorithms)."""
    m.distributed.initialize("cuda", backend="nccl",
                             init_method=f"tcp://127.0.0.1:{free_port()}",
                             world_size=1, rank=0)
    try:
        mesh = m.sharding.make_mesh()
        cfg = m.DISYoloConfig(image_size=size, compute_dtype="float32",
                              locked_layers=(), batch_size=2)
        runs = []
        with deterministic(torch):
            for use in (None, mesh):
                model = m.api.init_model(cfg, DP_SEED)
                state = m.ts.init_train_state(model, mesh=use)
                step = m.ts.make_train_step(model, mesh=use)
                gen = torch.Generator().manual_seed(11)
                for b in batches[:2]:
                    _, metrics = step(state, {k: v[:2] for k, v in b.items()}, gen)
                runs.append((metrics, state_digest(torch, model, state.opt)))
                del model, state, step
        torch.cuda.empty_cache()
    finally:
        m.distributed.shutdown()
    (m0, d0), (m1, d1) = runs
    equal = d0 == d1 and all(torch.equal(m0[k], m1[k]) for k in m0)
    need(equal, "world size 1 over NCCL: the mesh step differs from the step "
         "without a mesh")
    return {"bit_equal": equal, "steps": 2, "loss": float(m1["total_loss"])}


def dp_cli(root, size, device):
    """``cli train --data-parallel`` under ``torch.distributed.run``: two
    ranks on the one card (gloo), 2 steps at the global batch, a
    validation and a checkpoint at step 2.  Fails unless both ranks
    joined over gloo, rank 0 alone logged the metrics (2 train rows, 1
    validation row) and the step's checkpoint is on disk."""
    out = os.path.join(root, "dp_cli")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (here, os.environ.get("PYTHONPATH")))))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
           "--master-port", str(free_port()), "-m", "dis_yolo_tpu_torch.cli",
           "train", "--data-parallel", "--dataset", root, "--output-dir", out,
           "--image-size", str(size), "--batch-size", str(DP_GLOBAL_BATCH),
           "--max-iter", "2", "--save-iter", "2", "--summary-iter", "1",
           "--device", device]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=here, env=env)
    wall = time.time() - t0
    log = proc.stdout + proc.stderr
    need(proc.returncode == 0, "cli train --data-parallel failed:\n" + log[-6000:])
    for r in (0, 1):
        need(f"rank {r} of 2, backend gloo" in log,
             f"cli train --data-parallel: rank {r} did not join over gloo:\n"
             + log[-3000:])
    ckpt_dir = os.path.join(out, "checkpoint")
    rows = open(os.path.join(ckpt_dir, "train_metrics.jsonl")).read().splitlines()
    kinds = [json.loads(r)["kind"] for r in rows]
    need(kinds.count("train") == 2 and kinds.count("val") == 1,
         f"cli train --data-parallel: metric rows {kinds}")
    need(os.path.isfile(os.path.join(ckpt_dir, "step_00000002", "state")),
         "cli train --data-parallel: no step-2 checkpoint")
    shutil.rmtree(out, ignore_errors=True)
    return {"wall_s": wall, "metric_rows": kinds}


def parallel_phase(np, torch, root, smi_line, size=576, device="cuda"):
    """The data-parallel phase on the Solver's split (module docstring).
    ``device="cpu"`` (a rehearsal at a small ``size``) runs it on CPU
    ranks and leaves out the NCCL parts.  Returns (record, the DP
    training path's launches)."""
    m = parallel_modules()
    dev = torch.device(device)
    batches = dp_batches(np, m, size)
    rec = {"nvidia_smi": smi_line}
    t0 = time.time()
    ref_rec, ref_sample = dp_train(np, torch, m, None, dev, batches, size)
    rec["one_process"] = ref_rec
    # a threshold that fills the detection slots on these images
    cfg = m.DISYoloConfig(dataset=root, image_size=size, test_size=size)
    images = m.DefectValData(cfg, "val").get()[0]
    model = m.api.init_model(cfg, DP_SEED, device=dev)
    thresh = m.calibrate_threshold(model, images[:2], cfg)
    del model
    ref_sweep = dp_sweep(np, torch, m, None, dev, root, thresh, size)
    ref_sp, ref_sp_arrays, int8 = sp_run(np, torch, m, None, dev, root,
                                         thresh, size)
    if dev.type == "cuda":
        rec["nccl_world1"] = dp_world1_nccl(np, torch, m, batches, size)
    print(f"parallel: one process and world-size-1 NCCL done in "
          f"{time.time() - t0:.0f} s", flush=True)

    results, wall = run_dp_workers(np, root, "gloo", "gloo", 2, True, thresh,
                                   size, device, int8=int8)
    os.remove(int8["probe"])
    recs = [r for r, _ in results]
    on = "cuda:0" if dev.type == "cuda" else "cpu"
    need(all(r["backend"] == "gloo" and r["device"] == on for r in recs)
         and not any(r["jax_imported"] for r in recs),
         f"parallel: gloo ranks {[(r['backend'], r['device']) for r in recs]}")
    gloo = dp_compare_train(np, "gloo 2 ranks, one card", results, ref_rec,
                            ref_sample)
    for route, want in ref_sweep.items():
        for r, arrays in results:
            got = arrays[f"boxes:{route}"]
            keep = lambda bx: [np.flatnonzero(x[:, 5] > 0).tolist() for x in bx]
            need(keep(got) == keep(want["boxes"]) and np.allclose(
                got, want["boxes"], rtol=1e-5, atol=1e-6)
                and r["sweep"][route]["mAP"] == want["mAP"],
                f"parallel sweep {route} rank {r['rank']}: not the one-process "
                f"sweep's (mAP {r['sweep'][route]['mAP']} vs {want['mAP']}, kept "
                f"{[len(k) for k in keep(got)]} vs "
                f"{[len(k) for k in keep(want['boxes'])]}, max |diff| "
                f"{float(np.abs(got - want['boxes']).max())})")
    # the paste of the device_score route is K5 on the card, in every
    # rank and in one process; the host route pastes on the host
    k5_sweep = {route: [r["sweep"][route]["launches_K5"] for r in recs]
                for route in ref_sweep}
    for route, want in ref_sweep.items():
        on_card = dev.type == "cuda" and route == "device_score"
        need(all((n > 0) == on_card for n in
                 k5_sweep[route] + [want["launches_K5"]]),
             f"parallel sweep {route}: K5 launches {k5_sweep[route]} by rank, "
             f"{want['launches_K5']} in one process")
    gloo.update(worker_wall_s=wall, ranks=recs,
                sweep={route: {"mAP": w["mAP"], "kept": int((w["boxes"][..., 5] > 0).sum()),
                               "one_process_predict_s": w["predict_s"],
                               "launches_K5_by_rank": k5_sweep[route],
                               "launches_K5_one_process": w["launches_K5"]}
                       for route, w in ref_sweep.items()})
    rec["gloo_2rank_one_card"] = gloo
    sp = sp_compare(np, results, ref_sp, ref_sp_arrays)
    rec["spatial_sp2_one_card"] = sp
    rec["int8_predict"], rec["remat_step"] = sp["int8_predict"], sp["remat_step"]
    launches = {"K1": sum(r[p]["launches"]["K1"] for r in recs
                          for p in ("f32_stage2", "bf16_default", "spatial")),
                "K2": 0,
                "K3": sum(r[p]["launches"]["K3"] for r in recs
                          for p in ("f32_stage2", "bf16_default", "spatial")),
                "K4": 0,
                "K5": sum(sum(n) for n in k5_sweep.values())}
    med = lambda xs: sorted(xs)[len(xs) // 2]
    print(f"parallel: spatial sp=2 on one card: predict ms per rank f32 "
          f"{[round(med(x['predict_f32']['ms']), 2) for x in sp['ranks']]} bf16 "
          f"{[round(med(x['predict_bf16']['ms']), 2) for x in sp['ranks']]} (one "
          f"process {round(med(ref_sp['predict_f32']['ms']), 2)} / "
          f"{round(med(ref_sp['predict_bf16']['ms']), 2)}); f32 step wall "
          f"{[round(x, 4) for x in sp['ranks'][0]['step_f32_stage2']['step_wall_s']]} s "
          f"(one process at B={SP_BATCH}: "
          f"{[round(x, 4) for x in ref_sp['step_f32_stage2']['step_wall_s']]} s); "
          f"step-1 loss rel {sp['step1_loss_rel']:.3g}; bf16 predict exchanges "
          f"{sp['ranks'][0]['predict_bf16']['exchanged_per_predict']}; K1/K3 "
          f"{[x['launches'] for x in sp['ranks']]}; {smi_line}", flush=True)
    q, rm = rec["int8_predict"], rec["remat_step"]
    gb = lambda xs: [None if x is None else round(x / 1e9, 3) for x in xs]
    print(f"parallel: spatial int8 predict ms per rank "
          f"{[round(med(x), 2) for x in q['ms_per_rank']]} (one process "
          f"{round(med(q['ms_one_process']), 2)}), kept {q['kept']} vs "
          f"{q['kept_one_process']}, exchanges {q['exchanged_per_predict'][0]}, "
          f"{'/'.join(q['probe_layers_bit_equal'])} accumulators bit-equal, K1 "
          f"{q['launches_K1']}; remat step wall "
          f"{[round(x, 4) for x in rm['remat']['step_wall_s'][0]]} s against "
          f"{[round(x, 4) for x in rm['plain']['step_wall_s'][0]]} s, peak per "
          f"rank {gb(rm['remat']['peak_bytes'])} against "
          f"{gb(rm['plain']['peak_bytes'])} GB, metrics and state equal, K3 "
          f"{rm['remat']['launches_K3']}; {smi_line}", flush=True)
    print(f"parallel: gloo 2 ranks on one card: f32 step wall "
          f"{[round(x, 4) for x in recs[0]['f32_stage2']['step_wall_s']]} s, bf16 "
          f"{[round(x, 4) for x in recs[0]['bf16_default']['step_wall_s']]} s "
          f"(one process at B={DP_GLOBAL_BATCH}: "
          f"{[round(x, 4) for x in ref_rec['bf16_default']['step_wall_s']]} s), "
          f"packed all-reduce {[round(x, 2) for x in recs[0]['packed_all_reduce']['ms']]} ms "
          f"for {recs[0]['packed_all_reduce']['bytes']} B; {smi_line}", flush=True)

    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        results, wall = run_dp_workers(np, root, "nccl", "nccl", 2, False, thresh,
                                       size)
        recs = [r for r, _ in results]
        need([r["device"] for r in recs] == ["cuda:0", "cuda:1"]
             and all(r["backend"] == "nccl" for r in recs),
             f"parallel: nccl ranks {[(r['backend'], r['device']) for r in recs]}")
        nccl = dp_compare_train(np, "nccl 2 ranks", results, ref_rec, ref_sample)
        nccl.update(worker_wall_s=wall, ranks=recs)
        rec["nccl_2rank"] = nccl
        print(f"parallel: nccl 2 ranks: packed all-reduce "
              f"{[round(x, 2) for x in recs[0]['packed_all_reduce']['ms']]} ms; "
              f"{smi_line}", flush=True)
    else:
        rec["nccl_2rank"] = "skipped: 1 device"
        print("parallel: nccl_2rank skipped: 1 device", flush=True)

    rec["cli"] = dp_cli(root, size, device)
    print(f"parallel: cli train --data-parallel (2 ranks, gloo) in "
          f"{rec['cli']['wall_s']:.1f} s", flush=True)
    rec["phase_s"] = time.time() - t0
    return rec, launches


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    parser.add_argument("--artifact-worker", help=argparse.SUPPRESS)
    parser.add_argument("--dp-worker", help=argparse.SUPPRESS)
    args = parser.parse_args()

    # a fixed cuBLAS workspace, so that the device-data phase can run
    # under deterministic algorithms; set before the card is first used
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if args.dp_worker:          # its rank's device is in its spec
        dp_worker(args.dp_worker)
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if args.artifact_worker:
        artifact_worker(args.artifact_worker)
        return
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dis_yolo_tpu_torch.config import DISYoloConfig
    from dis_yolo_tpu_torch.models import api, fold, quant, s2d
    from dis_yolo_tpu_torch.ops import (_build, cuda_assembly, custom_ops,
                                        mask_assembly, nms, paste)
    from dis_yolo_tpu_torch.train import train_step as ts
    from dis_yolo_tpu_torch.train.synthetic import synthetic_batch
    from dis_yolo_tpu_torch.losses.mask_loss import draw_uniforms
    from dis_yolo_tpu_torch.utils import profiling
    from dis_yolo_tpu_torch.utils.runtime import calibrate_threshold

    # ---- phase 1: device and build ------------------------------------
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{kind} x{count}; {smi_line}", flush=True)
    t0 = time.time()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.time() - t0:.1f} s", flush=True)
    ptxas = {}
    for name, path in libs.items():
        log = path.with_suffix(".log")
        ptxas[name] = ptxas_usage(log.read_text()) if log.exists() else {}
        for fn, use in ptxas[name].items():
            print(f"  {name}: {fn}: {json.dumps(use)}", flush=True)
    entries = config_entries(_build)

    # ---- phase 2: kernels against their plain versions ----------------
    gen = torch.Generator().manual_seed(0)
    k1_err = max(check_assembly(torch, custom_ops, gen, 2, 288, 3, 30, 5),
                 check_assembly(torch, custom_ops, gen, 1, 576, 3, 30, 3),
                 check_assembly(torch, custom_ops, gen, 1, 288, 5, 30, 3),
                 check_assembly(torch, custom_ops, gen, 1, 288, 7, 30, 3),
                 # odd S (rows off the 16-byte grid), S=576, k=5/7, boxes
                 # on the map's edges, 1-pixel, inverted and zero boxes
                 *(check_assembly_edges(torch, custom_ops, entries["assembly"],
                                        gen, b, s, k, 30)
                   for b, s, k in ((2, 145, 3), (1, 145, 5), (1, 145, 7),
                                   (1, 576, 3), (2, 288, 3))))
    k2_errs = [check_nms(torch, nms, custom_ops, entries["nms"],
                         nms_case(torch, gen, b, kk), 30, f"K={kk} B={b}", kept)[1]
               for b, kk, kept in ((2, 512, 20), (1, 1024, 10), (1, 100, 10),
                                   # one warp, a ragged warp, one candidate,
                                   # the limit
                                   (3, 1, 0), (3, 31, 3), (3, 33, 3), (3, 1024, 30))]
    case = nms_knife_edge(torch, np)
    got, err = check_nms(torch, nms, custom_ops, entries["nms"], case, 34, "knife edge")
    k2_errs.append(err)
    kept_second = int(((got >= 0) & (got % 2 == 1)).sum())
    need(0 < kept_second < 17, f"K2 knife edge not straddled: {kept_second}/17")
    print(f"K2 knife edge (IoU within 8 ulp of 0.3): {kept_second}/17 second "
          f"boxes kept", flush=True)
    # more rounds than valid candidates; a single round
    k2_errs.append(check_nms(torch, nms, custom_ops, entries["nms"],
                             nms_case(torch, gen, 2, 64), 100, "K=64 B=2 max_det=100",
                             2)[1])
    k2_errs.append(check_nms(torch, nms, custom_ops, entries["nms"],
                             nms_case(torch, gen, 2, 512), 1, "K=512 B=2 max_det=1",
                             2)[1])
    # scores in no order (the general route)
    case = nms_case(torch, gen, 2, 512)
    perm = torch.randperm(512, generator=gen).cuda()
    case = [t[:, perm].contiguous() for t in case]
    k2_errs.append(check_nms(torch, nms, custom_ops, entries["nms"], case, 30,
                             "K=512 B=2 shuffled", 20)[1])
    # a valid -inf inside the list (image 0) and last (image 1)
    case = nms_case(torch, gen, 2, 512)
    case[1][0, 10], case[1][1, 511] = -float("inf"), -float("inf")
    case[3][:, 10], case[3][:, 511] = True, True
    k2_errs.append(check_nms(torch, nms, custom_ops, entries["nms"], case, 30,
                             "K=512 B=2 valid -inf", 20)[1])
    # a valid NaN (image 0: nothing kept) and an invalid NaN (image 1: ignored)
    case = nms_case(torch, gen, 2, 512)
    case[1][:, 5] = float("nan")
    case[3][0, 5], case[3][1, 5] = True, False
    k2_errs.append(check_nms(torch, nms, custom_ops, entries["nms"], case, 30,
                             "K=512 B=2 valid NaN / invalid NaN", 10, none_in=(0,))[1])
    k2_err = max(k2_errs)

    k3_cases = [check_assembly_bwd(torch, cuda_assembly, custom_ops, mask_assembly, gen,
                                   b, s, k, r, n_zero, check_grad, edit)
                for b, s, k, r, n_zero, check_grad, edit in (
                    (2, 288, 3, 10, 2, True, None), (1, 576, 3, 4, 1, True, None),
                    (1, 288, 5, 10, 2, False, None), (1, 288, 7, 10, 2, False, None),
                    # the edges of the row-per-block design: a row length
                    # and band start off the 16-byte grid (S=97), k=1, the
                    # shared-memory accumulators (k=16), one ROI, MAX_ROIS,
                    # a ROI over the whole map, rows that meet no ROI
                    (2, 97, 3, 10, 2, False, None), (2, 64, 1, 10, 2, False, None),
                    (1, 32, 16, 10, 2, False, None), (2, 64, 3, 1, 0, False, "upright"),
                    (1, 48, 3, cuda_assembly.MAX_ROIS, 16, False, None),
                    (2, 97, 3, 10, 0, False, "full"), (2, 64, 3, 10, 0, False, "top"))]
    k3_err = max(e for e, _ in k3_cases)
    grad_rel = max(r for _, r in k3_cases)

    k4_err = max(check_extract(torch, cuda_assembly, gen, b, s, k, dtype, offset)
                 for dtype in (torch.bfloat16, torch.float32)
                 for b, s, k, offset in (
                     (1, 288, 3, 0), (2, 288, 3, 0), (1, 576, 3, 0),
                     (2, 576, 3, 0), (2, 64, 5, 0), (1, 64, 7, 0),
                     # rows off the 16-byte grid (S=97), k=1, k=16 (k*k =
                     # 256, column tiles), B=3, an input view one element
                     # into its storage
                     (1, 97, 3, 0), (2, 64, 1, 0), (1, 97, 16, 0), (3, 64, 3, 0),
                     (1, 288, 3, 1), (2, 97, 5, 1)))
    for b, s, k in ((2, 288, 3), (1, 576, 3), (1, 64, 5), (1, 64, 7)):
        check_planes(torch, cuda_assembly, custom_ops, gen, b, s, k, 30, 3)
    k5 = [check_paste(torch, paste, custom_ops, profiling, gen, s, h0, w0,
                      edges=edges, timed=not edges)
          for edges in (False, True) for s, (h0, w0) in PASTE_SHAPES]
    # odd sides: K5's byte stores (a width not a multiple of 4) and a last
    # group of rows short of 4
    k5.append(check_paste(torch, paste, custom_ops, profiling, gen, 576, 375,
                          499, b=2, edges=True))
    print(f"phase 2 done at {time.time() - t_start:.0f} s", flush=True)

    # ---- phase 3: the slice -------------------------------------------
    cfg = DISYoloConfig()
    size = cfg.image_size
    # seed 7: on this image its random weights give 30 NMS survivors
    # within the 512-candidate shortlist (seeds 0-3 saturate below 30:
    # their top-scored boxes overlap), so every detection slot is used
    model = api.init_model(cfg, seed=7)
    model_k2 = api.create_model(cfg.replace(use_pallas_nms=True))
    model_k2.load_state_dict(model.state_dict())
    rng = np.random.RandomState(0)
    batch = torch.from_numpy(rng.rand(2, size, size, 3).astype(np.float32)).cuda()
    images = {1: batch[:1], 2: batch}          # image 0 is shared
    windows = {b: torch.tensor([[0.0, 0.0, 1.0, 1.0], [0.05, 0.0, 0.95, 1.0]][:b]).cuda()
               for b in (1, 2)}
    thresh = calibrate_threshold(model, images[1], cfg)
    print(f"calibrated threshold {thresh:.6g}", flush=True)

    def serve(m, b, th=thresh):
        dets, masks = api.predict(m, images[b], windows[b], th)
        return (dets, masks) + paste.paste_masks_batch(masks, dets, size, size, size)

    profiling.reset_counters()
    outs = {(b, k2): serve(model_k2 if k2 else model, b)
            for b in (1, 2) for k2 in (False, True)}
    torch.cuda.synchronize()
    launches = kernel_launches(profiling, "K1", "K2", "K3", "K5")
    print(f"main path launches: {launches}", flush=True)
    need(launches["K1"] > 0 and launches["K2"] > 0 and launches["K5"] == 4,
         f"a kernel of the path never launched, or K5 not once a paste: "
         f"{launches}")
    for b in (1, 2):
        ref = outs[(b, False)]
        for x, y in zip(ref, outs[(b, True)]):
            need(torch.equal(x, y), f"B={b}: outputs differ with use_pallas_nms")
        dets, masks, full, valid, sem = ref
        ms = cfg.mask_size
        need(tuple(dets.shape) == (b, 30, 6) and tuple(masks.shape) == (b, 30, ms, ms),
             f"B={b}: shapes {tuple(dets.shape)} {tuple(masks.shape)}")
        need(tuple(full.shape) == (b, 30, size, size) and tuple(sem.shape) == (b, size, size),
             f"B={b}: paste shapes {tuple(full.shape)} {tuple(sem.shape)}")
        need(bool(torch.isfinite(dets).all() and torch.isfinite(masks).all()),
             f"B={b}: non-finite outputs")
        need(int((dets[0, :, 5] > 0).sum()) == 30,
             f"B={b}: {int((dets[0, :, 5] > 0).sum())} detections in image 0")
        need(bool(valid[0].any() and full.any()), f"B={b}: nothing pasted")
        print(f"slice B={b}: {int((dets[..., 5] > 0).sum())} detections, "
              f"{int(valid.sum())} pasted, identical with K2", flush=True)

    cfg32 = cfg.replace(compute_dtype="float32")
    model32 = api.create_model(cfg32)
    model32.load_state_dict(model.state_dict())
    raws = api.forward(model32, images[1])
    dets32, masks32 = api.predict_from_outputs(cfg32, raws, windows[1], thresh)
    plain = custom_ops.assemble_masks_batch_plain(raws[3], dets32[..., :4],
                                                     cfg.k_map)
    need(torch.equal(masks32 != 0, plain != 0), "f32: K1 support differs from plain")
    f32_err = float((masks32 - plain).abs().max())
    need(f32_err <= 1e-6, f"f32: K1 vs plain assembly error {f32_err}")
    model_cpu = api.create_model(cfg32, device="cpu")
    model_cpu.load_state_dict(model.state_dict())
    raws_cpu = api.forward(model_cpu, images[1].cpu(), device="cpu")
    fwd_err = []
    for g, w in zip(raws, raws_cpu):
        scale = max(1.0, float(w.abs().max()))
        fwd_err.append(float((g.cpu() - w).abs().max()) / scale)
    need(max(fwd_err) <= 1e-3, f"f32 forward card vs CPU: rel err {fwd_err}")
    dets_cpu, _ = api.predict_from_outputs(cfg32, raws_cpu, windows[1].cpu(),
                                           thresh, device="cpu")
    same_keep = torch.equal(dets32[..., 5].cpu() > 0, dets_cpu[..., 5] > 0)
    print(f"f32: K1 vs plain max err {f32_err:.3g}; forward card vs CPU max "
          f"rel err {max(fwd_err):.3g}; keep set equal to CPU: {same_keep}",
          flush=True)
    del model32, model_cpu, raws_cpu

    # the training slice: the threshold calibrated above lets NMS
    # proposals reach the mask loss at random init, as a trained net's do
    tcfg = cfg.replace(obj_threshold=thresh)
    bsz, n_gt = tcfg.batch_size, tcfg.max_box_per_image
    wire = wire_batch(np, synthetic_batch, tcfg)
    tbatch = {k: torch.from_numpy(v).cuda() for k, v in wire.items()}
    trainer1 = api.create_model(tcfg)
    trainer1.load_state_dict(model.state_dict())
    trainer2 = api.create_model(tcfg.replace(locked_layers=()))
    keys = [k for k in trainer1.state_dict() if "num_batches_tracked" not in k]
    sd0 = {k: v.clone() for k, v in trainer1.state_dict().items()}
    state1, step1 = ts.init_train_state(trainer1), ts.make_train_step(trainer1)
    gen_t = torch.Generator().manual_seed(1)

    profiling.reset_counters()
    metrics = []
    for _ in range(3):
        state1, m = step1(state1, tbatch, gen_t)
        metrics.append(m)
    sd1 = {k: v.clone() for k, v in trainer1.state_dict().items()}
    trainer2.load_state_dict(sd1)
    state2, step2 = ts.init_train_state(trainer2), ts.make_train_step(trainer2)
    for _ in range(2):
        state2, m = step2(state2, tbatch, gen_t)
        metrics.append(m)
    sd2 = {k: v.clone() for k, v in trainer2.state_dict().items()}
    # the same stage-2 step with and without K2 from the same state; the
    # metrics come from the forward, run with deterministic cuDNN
    same = []
    for use_k2 in (False, True):
        m_k2 = api.create_model(tcfg.replace(locked_layers=(), use_pallas_nms=use_k2))
        m_k2.load_state_dict(sd1)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            same.append(ts.make_train_step(m_k2)(
                ts.init_train_state(m_k2), tbatch,
                torch.Generator().manual_seed(2))[1])
        del m_k2
    torch.cuda.synchronize()
    train_launches = kernel_launches(profiling, "K1", "K2", "K3")
    print(f"training path launches: {train_launches}", flush=True)
    need(train_launches["K1"] > 0 and train_launches["K3"] > 0
         and train_launches["K2"] > 0,
         f"a kernel of the training path never launched: {train_launches}")
    for i, m in enumerate(metrics):
        need(all(bool(torch.isfinite(v)) for v in m.values()),
             f"train step {i}: non-finite metrics {m}")
    need(state1.opt.total_notfinite == 0 and state2.opt.total_notfinite == 0,
         "a training step was skipped as non-finite")
    locked = {k for k in keys if ts.layer_id(k) in tcfg.locked_layers}
    moved1 = state_moved(sd0, sd1, keys)
    need(not (moved1 & locked), f"stage 1 moved locked entries: {sorted(moved1 & locked)[:5]}")
    need(moved1 == set(keys) - locked,
         f"stage 1 left unlocked entries unmoved: {sorted(set(keys) - locked - moved1)[:5]}")
    moved2 = state_moved(sd1, sd2, keys)
    need(moved2 == set(keys),
         f"stage 2 left entries unmoved: {sorted(set(keys) - moved2)[:5]}")
    for name in same[0]:
        need(torch.equal(same[0][name], same[1][name]),
             f"train step {name} differs with use_pallas_nms: "
             f"{float(same[0][name])} vs {float(same[1][name])}")
    print("train metrics per step: " + json.dumps(
        [{k: float(v) for k, v in m.items()} for m in metrics]), flush=True)
    print(f"training slice: 3 stage-1 + 2 stage-2 steps finite; {len(locked)} "
          f"locked entries unchanged, {len(moved1)} moved in stage 1, "
          f"{len(moved2)} in stage 2; metrics identical with K2", flush=True)

    # one float32 step's loss and score-map gradient, card (K1/K3, TF32
    # off) against the CPU (plain versions), with the same uniforms; the
    # proposals are switched off so the ROIs are the exact GT boxes and no
    # rounded proposal edge can flip between the two
    cfg32t = tcfg.replace(compute_dtype="float32", locked_layers=(),
                          obj_threshold=1.0)
    u_prop, u_gt = draw_uniforms(torch.Generator().manual_seed(3), bsz,
                                 cfg32t.max_detection, n_gt, "cpu")

    def loss_and_sm_grad(dev):
        m32 = api.create_model(cfg32t, device=dev)
        m32.load_state_dict(sd1)
        m32.requires_grad_(False)
        held = {}

        def hold(_mod, _inp, out):
            held["sm"] = out[3].detach().requires_grad_(True)
            return out[:3] + (held["sm"],)

        m32.register_forward_hook(hold)
        batch = ts.prepare_batch({k: torch.from_numpy(v).to(dev)
                                  for k, v in wire.items()})
        total, mets = ts.total_loss(m32, batch, u_prop.to(dev), u_gt.to(dev))
        (grad,) = torch.autograd.grad(total, held["sm"])
        return {k: float(v.detach()) for k, v in mets.items()}, grad.cpu()

    mets_card, g_card = loss_and_sm_grad("cuda")
    mets_cpu, g_cpu = loss_and_sm_grad("cpu")
    loss_rel = abs(mets_card["total_loss"] - mets_cpu["total_loss"]) / abs(mets_cpu["total_loss"])
    mask_rel = abs(mets_card["mask_loss"] - mets_cpu["mask_loss"]) / abs(mets_cpu["mask_loss"])
    grad_err = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
    # total: an anchor whose best IoU sits within rounding of ignore_thresh
    # flips its no-object term (about 0.35 of a ~250 loss); the mask loss
    # and its gradient are smooth in the score maps, which the two
    # forwards give to ~1e-5 (f32, TF32 off, sums in other orders)
    need(mets_cpu["mask_loss"] > 0, "f32 train check: no positive ROI")
    need(loss_rel <= 1e-2 and mask_rel <= 1e-4,
         f"f32 train loss card vs CPU: total rel {loss_rel}, mask rel {mask_rel}")
    need(grad_err <= 1e-3, f"f32 score-map gradient card vs CPU: rel err {grad_err}")
    print(f"f32 train step card vs CPU: total loss rel {loss_rel:.3g}, mask loss "
          f"rel {mask_rel:.3g}, score-map grad max err / max|ref| {grad_err:.3g}",
          flush=True)

    # the serving graphs (bf16, the main path's dtype): each graph from the
    # seed-7 weights, its own calibrated threshold, predict + paste at B=1
    # and B=2, and the use_extract route (K4 + K1 planes) on its score maps
    print(f"training slice done at {time.time() - t_start:.0f} s", flush=True)
    k = cfg.k_map
    graphs, absmax = build_graphs(api, fold, quant, s2d, cfg,
                                  model.state_dict(), batch)
    g_thresh = {g: calibrate_threshold(m, images[1], gcfg)
                for g, (gcfg, m) in graphs.items()}
    print("serving graphs: thresholds " + json.dumps(g_thresh), flush=True)
    profiling.reset_counters()
    g_outs = {}
    for g, (gcfg, m) in graphs.items():
        for b in (1, 2):
            g_outs[(g, b)] = serve(m, b, g_thresh[g])
        raws = api.forward(m, images[2])
        dets2, masks2 = g_outs[(g, 2)][:2]
        for i in range(2):
            sm, bx = raws[3][i], dets2[i, :, :4]
            dflt = cuda_assembly.assemble_masks_cuda(sm, bx, k)
            # the head's bf16 values are the f32 map's: the cast is exact
            for one in (sm.to(torch.bfloat16), sm):
                ext = cuda_assembly.assemble_masks_cuda(one, bx, k,
                                                        use_extract=True)
                need(torch.equal(ext, dflt), f"graph {g} image {i}: "
                     f"use_extract route differs ({one.dtype})")
            need(torch.equal(dflt, masks2[i]),
                 f"graph {g} image {i}: assemble_masks_cuda != predict's masks")
    torch.cuda.synchronize()
    graph_launches = kernel_launches(profiling)
    print(f"serving graphs path launches: {graph_launches}", flush=True)
    need(graph_launches["K1"] > 0 and graph_launches["K4"] > 0,
         f"a kernel of the serving graphs' path never launched: {graph_launches}")
    for (g, b), (dets, masks, full, valid, sem) in g_outs.items():
        ms = cfg.mask_size
        need(tuple(dets.shape) == (b, 30, 6) and tuple(masks.shape) == (b, 30, ms, ms)
             and tuple(full.shape) == (b, 30, size, size),
             f"graph {g} B={b}: shapes {tuple(dets.shape)} {tuple(masks.shape)}")
        need(bool(torch.isfinite(dets).all() and torch.isfinite(masks).all()),
             f"graph {g} B={b}: non-finite outputs")
        need(int((dets[0, :, 5] > 0).sum()) == 30,
             f"graph {g} B={b}: {int((dets[0, :, 5] > 0).sum())} detections in image 0")
        need(bool(valid[0].any() and full.any()), f"graph {g} B={b}: nothing pasted")
        print(f"graph {g} ({GRAPH_NAMES[g]}) B={b}: "
              f"{int((dets[..., 5] > 0).sum())} detections, {int(valid.sum())} "
              f"pasted; use_extract route bit-equal", flush=True)

    # the serving graphs at float32 (TF32 off) against each other
    cfg32 = cfg.replace(compute_dtype="float32")
    model32 = api.create_model(cfg32)
    model32.load_state_dict(model.state_dict())
    graphs32, absmax32 = build_graphs(api, fold, quant, s2d, cfg32,
                                      model.state_dict(), batch)
    thresh32 = calibrate_threshold(model32, images[1], cfg32)
    held = {}
    for name in ("convolutional54", "convolutional80"):
        getattr(graphs32["d"][1], name).register_forward_pre_hook(
            lambda mod, a, _n=name: held.__setitem__(_n, a[0]))
    f32 = {}
    for g, (gcfg, m) in [("default", (cfg32, model32))] + list(graphs32.items()):
        raws = api.forward(m, images[2])
        dets, _ = api.predict_from_outputs(gcfg, raws, windows[2], thresh32)
        f32[g] = (raws, dets[..., 5] > 0)
    graph_checks = {}
    for g, base in (("a", "default"), ("b", "a"), ("c", "b")):
        errs = [rel_err(x, y) for x, y in zip(f32[g][0], f32[base][0])]
        same_keep = torch.equal(f32[g][1], f32[base][1])
        graph_checks[f"{g}_vs_{base}"] = {"max_rel_err": errs,
                                          "same_keep_set": same_keep,
                                          "kept": int(f32[g][1].sum())}
        # exact algebra, float32 summed in other orders: ~1e-6 expected
        need(max(errs) <= 1e-3, f"f32 graph {g} vs {base}: rel err {errs}")
        need(same_keep, f"f32 graph {g} vs {base}: keep sets differ")
    maes = [norm_mae(x, y) for x, y in zip(f32["d"][0], f32["b"][0])]
    graph_checks["d_vs_b_norm_mae"] = maes
    need(max(maes) < 0.25, f"f32 int8 graph vs deploy: normalized MAE {maes}")
    m_d32 = graphs32["d"][1]
    for name, x in held.items():
        layer = getattr(m_d32, name)
        x_q = quant.quantize_input(x, layer.inv_sx)
        acc = quant.int8_conv(x_q, layer.w_q, layer.stride)
        x_q_cpu = quant.quantize_input(x.cpu(), layer.inv_sx.cpu())
        acc_cpu = quant.int8_conv(x_q_cpu, layer.w_q.cpu(), layer.stride)
        need(torch.equal(x_q.cpu(), x_q_cpu), f"{name}: int8 input card != CPU")
        need(torch.equal(acc.cpu(), acc_cpu), f"{name}: int32 accumulators card != CPU")
        graph_checks[f"{name}_int32_equal_cpu"] = {
            "shape": list(acc.shape), "max_abs_acc": int(acc.abs().max())}
    print("f32 serving graphs: " + json.dumps(graph_checks), flush=True)
    del model32, graphs32, f32, held
    print(f"serving graphs done at {time.time() - t_start:.0f} s", flush=True)

    # the evaluation path: the seed-7 model with a threshold calibrated on
    # the eval split, its three sweep routes, with and without K2
    em = eval_modules()
    profiling.reset_counters()
    eval_record, eval_ctx = eval_phase(np, torch, em, cfg, model.state_dict())
    torch.cuda.synchronize()
    eval_launches = kernel_launches(profiling)
    print(f"eval path launches: {eval_launches}", flush=True)
    need(eval_launches["K1"] > 0 and eval_launches["K2"] > 0,
         f"a kernel of the eval path never launched: {eval_launches}")
    print("eval path: " + json.dumps(eval_record), flush=True)
    print(f"eval path done at {time.time() - t_start:.0f} s", flush=True)

    # the training loop: cli train stage 1 -> stage 2 -> resume over a
    # split written as P6 (read without OpenCV or PIL), under build/
    sol = solver_modules()
    build_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_root, exist_ok=True)
    sroot = tempfile.mkdtemp(prefix="solver_smoke_", dir=build_root)
    atexit.register(shutil.rmtree, sroot, True)
    profiling.reset_counters()
    solver_record, solver_runs = solver_phase(np, torch, sol, sroot)
    torch.cuda.synchronize()
    solver_launches = kernel_launches(profiling)
    print(f"Solver path launches: {solver_launches}", flush=True)
    need(solver_launches["K1"] > 0 and solver_launches["K3"] > 0,
         f"a kernel of the Solver's path never launched: {solver_launches}")
    solver_cfg = solver_runs[0].cfg.replace(output_dir=sroot)
    del solver_runs
    torch.cuda.empty_cache()
    print("Solver run: " + json.dumps(solver_record), flush=True)
    print(f"Solver run done at {time.time() - t_start:.0f} s", flush=True)

    # device-data training: on-card augmentation and corpus assembly
    # against the CPU, K-step blocks, grad_accum, remat, and the command
    # with --device-corpus on the Solver's split (its launches are the
    # path's)
    dd = device_data_modules()
    dd_record = device_data_phase(np, torch, dd, sroot, model.state_dict())
    profiling.reset_counters()
    dd_record.update(device_data_command(np, torch, dd, sroot))
    torch.cuda.synchronize()
    dd_launches = kernel_launches(profiling)
    print(f"device-data path launches: {dd_launches}", flush=True)
    need(dd_launches["K1"] > 0 and dd_launches["K3"] > 0,
         f"a kernel of the device-data path never launched: {dd_launches}")
    print("device-data command: " + json.dumps(dd_record["command"]), flush=True)
    print(f"device-data training done at {time.time() - t_start:.0f} s", flush=True)

    # data parallelism: two ranks on this card over gloo (training against
    # one process, the sweep), world size 1 over NCCL, two NCCL ranks when
    # there are two cards, and cli train --data-parallel under torchrun
    # (the launches are the ranks' training runs, read in their processes)
    dp_record, dp_launches = parallel_phase(np, torch, sroot, smi_line)
    print(f"parallel path launches: {dp_launches}", flush=True)
    print(f"parallel done at {time.time() - t_start:.0f} s", flush=True)

    # the serving export: artifacts saved, loaded in a fresh process and
    # run there; cli infer / export / verify-gt on the Solver's split
    xm = export_modules()
    xroot = tempfile.mkdtemp(prefix="export_smoke_", dir=build_root)
    atexit.register(shutil.rmtree, xroot, True)
    x_images = {1: images[1], 2: images[2], 3: torch.cat([images[2], torch.from_numpy(
        np.random.RandomState(1).rand(1, size, size, 3).astype(np.float32)).cuda()])}
    x_windows = {1: windows[1], 2: windows[2],
                 3: torch.cat([windows[2], windows[2][:1]])}
    profiling.reset_counters()
    export_record, export_ctx = export_phase(np, torch, xm, api, graphs, g_thresh,
                                             x_images, x_windows, xroot, sroot,
                                             model.state_dict(), size)
    torch.cuda.synchronize()
    # in this process (the live predicts) and in the artifacts' process
    export_launches = kernel_launches(profiling)
    for k in ("K1", "K2"):
        export_launches[k] += export_record["worker_launches"][k]
    print(f"export path launches: {export_launches}", flush=True)
    need(export_record["worker_launches"]["K1"] > 0
         and export_record["worker_launches"]["K2"] > 0,
         f"a kernel of the export path never launched: {export_launches}")
    print("export path: " + json.dumps(export_record), flush=True)
    print(f"export path done at {time.time() - t_start:.0f} s", flush=True)

    # ---- phase 4: timing ----------------------------------------------
    timings = {}
    for b in (1, 2):
        timings[f"forward_ms_b{b}"] = cuda_ms(
            torch, lambda: api.forward(model, images[b]), 20)
        timings[f"predict_ms_b{b}"] = cuda_ms(
            torch, lambda: api.predict(model, images[b], windows[b], thresh), 20)
        timings[f"predict_paste_ms_b{b}"] = cuda_ms(
            torch, lambda: serve(model, b), 20)
        timings[f"predict_k2_ms_b{b}"] = cuda_ms(
            torch, lambda: api.predict(model_k2, images[b], windows[b], thresh), 20)
    # train steps go on from the slice's state (they train as they are timed)
    timings["train_step_ms_stage1_b2"] = cuda_ms(
        torch, lambda: step1(state1, tbatch, gen_t), 5, warmup=2, repeats=3)
    timings["train_step_ms_stage2_b2"] = cuda_ms(
        torch, lambda: step2(state2, tbatch, gen_t), 5, warmup=2, repeats=3)
    # stage 1 without the locked layers' gradients (skip_nonfinite_updates
    # off: no finite check, so the backward stops at layer 53) beside the
    # default, which takes them for the check
    trainer1n = api.create_model(tcfg.replace(skip_nonfinite_updates=False))
    trainer1n.load_state_dict(sd1)
    state1n, step1n = ts.init_train_state(trainer1n), ts.make_train_step(trainer1n)
    timings["train_step_ms_stage1_b2_no_locked_grads"] = cuda_ms(
        torch, lambda: step1n(state1n, tbatch, gen_t), 5, warmup=2, repeats=3)
    print("timings " + json.dumps(timings), flush=True)
    stage1_traces = {
        "default_locked_grads_checked": profile_window(
            torch, lambda: step1(state1, tbatch, gen_t), 2,
            timings["train_step_ms_stage1_b2"]),
        "no_locked_grads": profile_window(
            torch, lambda: step1n(state1n, tbatch, gen_t), 2,
            timings["train_step_ms_stage1_b2_no_locked_grads"])}
    del trainer1n, state1n, step1n
    print("trace train step stage 1 B=2: " + json.dumps(
        {k: {"device_busy_us_per_call": v["device_busy_us_per_call"],
             "device_idle_share": v["device_idle_share"],
             "kernel_launches_per_call": v["kernel_launches_per_call"]}
         for k, v in stage1_traces.items()}), flush=True)

    # the training loop: loader, Solver steps, checkpoint, forward cuts
    solver_times = solver_timing_run(np, torch, sol, sroot, solver_cfg, model.state_dict())
    for key in ("solver_stage1", "solver_stage2", "solver_stage1_loader_workers4"):
        t = solver_times[key]
        print(f"{key} B=2: wall {t['wall_s_per_step']:.4f} s/step, "
              f"train_timer {t['train_timer_s_per_step']:.4f}, load_timer "
              f"{t['load_timer_s_per_step']:.4f} s/step; {smi_line}", flush=True)
    print("Solver timing: " + json.dumps(solver_times), flush=True)
    print(f"phase 4 Solver timing done at {time.time() - t_start:.0f} s", flush=True)
    dd_times = device_data_timing(np, torch, dd, sroot, model.state_dict())
    print(f"phase 4 device-data timing done at {time.time() - t_start:.0f} s", flush=True)
    for key, t in dd_times.items():
        if key == "corpus_parts_device_ms":
            print(f"device-data corpus parts, device ms per call ({smi_line}): "
                  + json.dumps(t), flush=True)
            continue
        print(f"device-data {key} B=2: wall {t['wall_s_per_step']:.4f} s/step "
              f"(passes {[round(p_['wall_s_per_step'], 4) for p_ in t['passes']]}, "
              f"{t['steps']} steps each), train_timer "
              f"{t['train_timer_s_per_step']:.4f}, load_timer "
              f"{t['load_timer_s_per_step']:.4f} s/step, "
              f"{t['bytes_to_card_per_step']} B to the card per step; {smi_line}",
              flush=True)

    # the serving export: export s and MB per artifact, loaded vs live
    # predict ms, infer ms per image end to end
    export_times = export_timing(np, torch, xm, api, export_ctx, xroot, x_images,
                                 x_windows)
    export_times["export_s"] = {n: a["export_s"] + a["save_s"]
                                for n, a in export_record["artifacts"].items()}
    export_times["artifact_mb"] = {n: a["artifact_mb"]
                                   for n, a in export_record["artifacts"].items()}
    print(f"export timing ({smi_line}): " + json.dumps(
        {k: v for k, v in export_times.items()
         if k not in ("deploy_b1_here_profiles", "loaded_predict_ms")}
        | {"loaded_predict_ms": {n: {k: v for k, v in r.items() if k != "profile_b1"}
                                 for n, r in export_times["loaded_predict_ms"].items()}}),
        flush=True)
    for key, prof in export_times["deploy_b1_here_profiles"].items():
        print(f"deploy B=1 {key}, host ops: " + json.dumps(
            {k: v for k, v in prof.items() if k != "top_kernels_us_per_call"}),
            flush=True)

    # the eval sweep, s/image per route: device predict and host post
    eval_sweep = eval_timing(em, *eval_ctx)
    for route, t in eval_sweep.items():
        print(f"eval sweep {route}: predict {t['predict_s_per_image'] * 1e3:.2f} "
              f"ms/image, post {t['post_s_per_image'] * 1e3:.2f} ms/image "
              f"(fetch wait {t['fetch_wait_s_per_image'] * 1e3:.2f}); {smi_line}",
              flush=True)

    # the eval path's scoring products on one device_score batch: chunked
    # as they ship, and one product over the whole image as a yardstick
    scored = {}
    with capturing(scored, (paste, "mask_iou_batch"), (paste, "semantic_confusion")):
        em.run_split(eval_ctx[0], eval_ctx[1], *eval_ctx[3],
                     **eval_route_kwargs(eval_ctx[2], "device_score_semantic", {}))
    (full_b, gtp_b, gta_b), _ = scored["mask_iou_batch"]
    (sem_b, gts_b, n_sem), _ = scored["semantic_confusion"]
    det_f = full_b.flatten(-2).float()
    gt_f = paste.unpack_mask_bits(gtp_b, full_b.shape[-1]).flatten(-2).float()
    eval_scoring = {
        "shapes": {"full_masks": list(full_b.shape), "gt_packed": list(gtp_b.shape)},
        "mask_iou_batch_ms": graph_ms(torch, lambda: paste.mask_iou_batch(
            full_b, gtp_b, gta_b), n=5, reps=5),
        "one_product_intersections_ms": graph_ms(
            torch, lambda: torch.matmul(det_f, gt_f.transpose(-1, -2)), n=5, reps=5),
        "semantic_confusion_ms": graph_ms(torch, lambda: paste.semantic_confusion(
            sem_b, gts_b, n_sem), n=5, reps=5)}
    print(f"eval scoring B={full_b.shape[0]} D={full_b.shape[1]} "
          f"{full_b.shape[2]}x{full_b.shape[3]} G={gtp_b.shape[1]}: mask_iou_batch "
          f"{eval_scoring['mask_iou_batch_ms']:.3f} ms (one product over the image "
          f"{eval_scoring['one_product_intersections_ms']:.3f} ms), "
          f"semantic_confusion {eval_scoring['semantic_confusion_ms']:.3f} ms; "
          f"{smi_line}", flush=True)
    del det_f, gt_f

    # where the time goes: one traced window of predict + paste at B=1
    trace = profile_window(torch, lambda: serve(model, 1), 3,
                           timings["predict_paste_ms_b1"])
    print("trace predict+paste B=1: " + json.dumps(trace), flush=True)
    train_trace = profile_window(torch, lambda: step2(state2, tbatch, gen_t), 2,
                                 timings["train_step_ms_stage2_b2"])
    print("trace train step stage 2 B=2: " + json.dumps(train_trace), flush=True)

    # kernels at the main path's shapes and data: the arguments of one
    # B=1 predict with K2, recorded after the timed runs
    captured = {}
    with capturing(captured, (api, "assemble_masks_batch_cuda"),
                   (nms, "nms_cuda")):
        api.predict(model_k2, images[1], windows[1], thresh)
    (k1_args, k1_kw), (k2_args, k2_kw) = (captured["assemble_masks_batch_cuda"],
                                          captured["nms_cuda"])
    sm, bx, k = k1_args[0], k1_args[1], k1_args[2]
    k1 = lambda: custom_ops.assemble_masks_batch_cuda(*k1_args, **k1_kw)
    k1_plain_fn = lambda: custom_ops.assemble_masks_batch_plain(*k1_args, **k1_kw)
    k2 = lambda: custom_ops.nms_cuda(*k2_args, **k2_kw)
    k2_plain_fn = lambda: nms._select_suppress_nms(*k2_args[:4], k2_args[5],
                                                   k2_args[4])
    k1_ms, k1_plain, k2_ms, k2_plain = (graph_ms(torch, f) for f in
                                        (k1, k1_plain_fn, k2, k2_plain_fn))
    per_call = {name: cuda_ms(torch, f, 100) for name, f in
                (("K1", k1), ("K2", k2))}
    # K2 with a single selection round: the launch, the loads and the
    # prologue; the rest of K2's time is its other max_det - 1 rounds
    max_det = k2_args[4]
    per_call["K2_one_round_device"] = graph_ms(
        torch, lambda: custom_ops.nms_cuda(*k2_args[:4], 1, k2_args[5]))
    per_call["K2_per_round_device"] = ((k2_ms - per_call["K2_one_round_device"])
                                       / (max_det - 1))
    print("kernel ms per call incl. the host's wrapper and launch, and K2's one "
          "round and per round: " + json.dumps(per_call), flush=True)

    def k1_bound_of(scoremaps, boxes, k_):
        out_px = boxes.shape[0] * boxes.shape[1] * scoremaps.shape[2] ** 2
        return bound(scoremaps.numel() * 4 + boxes.numel() * 4 + out_px * 4,
                     out_px * (6 + 2 * (k_ - 1)))

    k1_bound = k1_bound_of(sm, bx, k)
    picked = custom_ops.nms_cuda(*k2_args, **k2_kw)
    kk = k2_args[1].shape[1]
    # greedy NMS needs one row of pair tests per winner and one argmax
    # over K per round (the kernel stops after the round that finds none)
    winners = int((picked >= 0).sum())
    rounds = int(torch.clamp((picked >= 0).sum(-1) + 1, max=picked.shape[1]).sum())
    k2_bound = bound(k2_args[1].numel() * (16 + 4 + 4 + 1) + picked.numel() * 8,
                     winners * kk * NMS_OPS_PER_PAIR + rounds * kk * 2)
    # the sorted route scans warp by warp: how many warps hold a winner
    k2_shape = {"K": kk, "valid": int(k2_args[3].sum()), "winners": winners,
                "warps_with_winners": int(torch.unique(picked[picked >= 0] // 32).numel())}
    print(f"K1 S={sm.shape[1]} D={bx.shape[1]}: {k1_ms * 1e3:.1f} us "
          f"(plain {k1_plain * 1e3:.1f} us, bound {k1_bound[0] * 1e3:.2f} us "
          f"by {k1_bound[1]}); K2 K={kk}: {k2_ms * 1e3:.1f} us (plain "
          f"{k2_plain * 1e3:.1f} us, bound {k2_bound[0] * 1e3:.3f} us by "
          f"{k2_bound[1]})", flush=True)
    # K2's routes on the same inputs, and each with one round
    k2_case = list(k2_args[:4])
    k2_sweep = [{"forced_general_route": bool(general),
                 "ms": graph_ms(torch, lambda: nms_config(
                     torch, entries["nms"], k2_case, max_det, k2_args[5], general)),
                 "one_round_ms": graph_ms(torch, lambda: nms_config(
                     torch, entries["nms"], k2_case, 1, k2_args[5], general))}
                for general in K2_ROUTES]
    print("K2 sweep: " + json.dumps(k2_sweep), flush=True)

    # K3 (and K1 in pixel-box mode) at the training path's shapes: the
    # arguments of one stage-2 step, recorded after the timed runs
    with capturing(captured, (cuda_assembly, "assemble_bwd_cuda"),
                   (custom_ops, "assemble_masks_batch_cuda")):
        step2(state2, tbatch, gen_t)
    (k3_args, _), (k1t_args, k1t_kw) = (captured["assemble_bwd_cuda"],
                                        captured["assemble_masks_batch_cuda"])
    roi_px, g_rois, k3_k = k3_args
    k3 = lambda: cuda_assembly.assemble_bwd_cuda(*k3_args)
    k3_plain_fn = lambda: mask_assembly.assemble_bwd_plain(*k3_args)
    k3_ms, k3_plain = graph_ms(torch, k3), graph_ms(torch, k3_plain_fn)
    per_call["K1_train_pixel_boxes_device"] = graph_ms(
        torch, lambda: custom_ops.assemble_masks_batch_cuda(*k1t_args, **k1t_kw))
    per_call["K3"] = cuda_ms(torch, k3, 100)
    s3 = g_rois.shape[-1]
    # what this run's ROIs need: g read only at the (ROI, pixel inside
    # it) pairs (g outside every ROI does not change the output), the
    # boxes read once, the dense gradient written once; one addition per
    # (ROI, pixel inside it)
    k3_inside = float(mask_assembly.box_inside_mask(roi_px, s3).sum())
    k3_bound = bound(k3_inside * 4 + roi_px.numel() * 4
                     + g_rois.shape[0] * s3 * s3 * k3_k * k3_k * 4, k3_inside)
    # yardsticks for the small kernels: one graph node of a 1-element
    # kernel (the launch), and a zero fill of K3's output (its stores)
    one = torch.zeros(1, device="cuda")
    per_call["one_element_node_device"] = graph_ms(torch, lambda: one.add_(1))
    k3_zeros = torch.empty((g_rois.shape[0], s3, s3, k3_k * k3_k), device="cuda")
    per_call["K3_output_zero_fill_device"] = graph_ms(torch, k3_zeros.zero_)
    k1_zeros = torch.empty((bx.shape[0], bx.shape[1], sm.shape[1], sm.shape[2]),
                           device="cuda")
    per_call["K1_output_zero_fill_device"] = graph_ms(torch, k1_zeros.zero_)
    print(f"one-element graph node {per_call['one_element_node_device'] * 1e3:.2f} us; "
          f"zero fill of K3's output {per_call['K3_output_zero_fill_device'] * 1e3:.2f} us; "
          f"of K1's {per_call['K1_output_zero_fill_device'] * 1e3:.2f} us", flush=True)
    print(f"K3 B={g_rois.shape[0]} R={g_rois.shape[1]} S={s3}: {k3_ms * 1e3:.1f} us "
          f"(plain {k3_plain * 1e3:.1f} us, bound {k3_bound[0] * 1e3:.2f} us by "
          f"{k3_bound[1]}); K1 pixel-box R={k1t_args[1].shape[1]}: "
          f"{per_call['K1_train_pixel_boxes_device'] * 1e3:.1f} us", flush=True)

    # the serving graphs: predict and predict+paste, B=1 and B=2
    for g, (gcfg, m) in graphs.items():
        for b in (1, 2):
            timings[f"{g}_predict_ms_b{b}"] = cuda_ms(
                torch, lambda: api.predict(m, images[b], windows[b], g_thresh[g]),
                10, repeats=3)
            timings[f"{g}_predict_paste_ms_b{b}"] = cuda_ms(
                torch, lambda: serve(m, b, g_thresh[g]), 10, repeats=3)
    print("serving graph timings " + json.dumps(
        {k_: v for k_, v in timings.items() if k_[1] == "_"}), flush=True)
    graph_traces = {}
    for g in ("b", "d"):
        m = graphs[g][1]
        graph_traces[g] = profile_window(
            torch, lambda: serve(m, 1, g_thresh[g]), 3,
            timings[f"{g}_predict_paste_ms_b1"])
        print(f"trace predict+paste B=1 graph {g}: "
              + json.dumps(graph_traces[g]), flush=True)

    # K4 at the serving graphs' shape (S=288, k=3, one image, as
    # assemble_masks_cuda calls it) on graph (b)'s score map, bf16 (the
    # head's dtype) and f32, beside its bound and the one PyTorch call
    # that computes the same function
    sm_b = api.forward(graphs["b"][1], images[1])[3]
    s4, kk = sm_b.shape[1], k * k
    k4 = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        sm2d = sm_b.to(dtype).reshape(1, s4, s4 * kk).contiguous()
        lib_out = torch.empty((kk, s4, s4), dtype=torch.float32, device="cuda")
        lib = lambda: lib_out.copy_(sm2d.view(s4, s4, kk).permute(2, 0, 1))
        need(torch.equal(lib()[None], cuda_assembly.extract_planes_cuda(sm2d, k)),
             f"K4 vs the library copy_ ({tag})")
        k4[tag] = {
            "ms": graph_ms(torch, lambda: cuda_assembly.extract_planes_cuda(sm2d, k)),
            "plain_ms": graph_ms(torch, lambda: cuda_assembly.extract_planes_plain(sm2d, k)),
            "library_ms": graph_ms(torch, lib),
            "bound": bound(sm2d.numel() * sm2d.element_size() + kk * s4 * s4 * 4, 0)}
        print(f"K4 S={s4} k={k} {tag} in: {k4[tag]['ms'] * 1e3:.2f} us (plain "
              f"{k4[tag]['plain_ms'] * 1e3:.2f} us, copy_ "
              f"{k4[tag]['library_ms'] * 1e3:.2f} us, bound "
              f"{k4[tag]['bound'][0] * 1e3:.2f} us by {k4[tag]['bound'][1]})",
              flush=True)
    # K1 on channel planes, on the serving path's captured inputs
    k1_planes = sm.permute(0, 3, 1, 2).contiguous()
    per_call["K1_planes_device"] = graph_ms(
        torch, lambda: custom_ops.assemble_masks_batch_cuda(
            k1_planes, bx, k, planes=True))
    print(f"K1 planes S={sm.shape[1]} D={bx.shape[1]}: "
          f"{per_call['K1_planes_device'] * 1e3:.1f} us (NHWC {k1_ms * 1e3:.1f} us)",
          flush=True)
    # K1's three modes beside their bounds (by bytes, as the main mode's),
    # and each mode's launch shapes: the serving path's normalized boxes,
    # the training forward's pixel boxes, channel planes
    k1_modes = {
        "normalized": ((sm, bx, k), {}, k1_ms),
        "pixel_boxes": (k1t_args, k1t_kw, per_call["K1_train_pixel_boxes_device"]),
        "planes": ((k1_planes, bx, k), {"planes": True}, per_call["K1_planes_device"])}
    k1_sweep = {}
    for mode, (a, kw, ms) in k1_modes.items():
        b_ms, b_by = k1_bound_of(*a)
        # the share of output pixels inside their box (exact 0 outside)
        inside = assembly_config(torch, entries["assembly"], *a, K1_CONFIGS[0], True,
                                 kw.get("pixel_boxes", False), kw.get("planes", False))
        k1_sweep[mode] = {
            "B": a[1].shape[0], "D": a[1].shape[1], "S": a[0].shape[2], "ms": ms,
            "inside_share": float((inside != 0).float().mean()),
            "bound_ms": b_ms, "bound_by": b_by,
            "launch_shapes": [
                {"threads": launch[0], "rows_per_thread": launch[1],
                 "ms": graph_ms(torch, lambda: assembly_config(
                     torch, entries["assembly"], *a, launch, **kw))}
                for launch in K1_CONFIGS]}
        best = min(k1_sweep[mode]["launch_shapes"], key=lambda c: c["ms"])
        print(f"K1 {mode} B={a[1].shape[0]} D={a[1].shape[1]} S={a[0].shape[2]}: "
              f"{ms * 1e3:.2f} us (bound {b_ms * 1e3:.2f} us by {b_by}); best "
              f"launch shape {best}", flush=True)

    # device memory of a B=2 predict+paste: int8 (im2col) against deploy
    peak_all_gb = torch.cuda.max_memory_allocated() / 1e9
    memory = {}
    for g in ("d", "b"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        serve(graphs[g][1], 2, g_thresh[g])
        torch.cuda.synchronize()
        memory[g] = {"allocated_before_gb": before / 1e9,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "working_set_gb":
                         (torch.cuda.max_memory_allocated() - before) / 1e9}
    print("predict+paste B=2 device memory: " + json.dumps(memory), flush=True)

    def path_launches(name):
        by_path = {"serving": launches.get(name, 0),
                   "training": train_launches.get(name, 0),
                   "serving_graphs": graph_launches[name],
                   "eval": eval_launches[name],
                   "solver": solver_launches[name],
                   "device_data": dd_launches[name],
                   "parallel": dp_launches[name],
                   "export": export_launches[name]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    kernels = [
        {"name": "K1 mask assembly + sigmoid", "route": "cuda",
         "source": "dis_yolo_tpu_torch/csrc/assembly.cu",
         "replaces": "dis_yolo_tpu/ops/pallas_assembly.py:276",
         **path_launches("K1"),
         "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "K2 class-aware greedy NMS", "route": "cuda",
         "source": "dis_yolo_tpu_torch/csrc/nms.cu",
         "replaces": "dis_yolo_tpu/ops/pallas_nms.py:73",
         **path_launches("K2"),
         "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "K3 mask assembly backward", "route": "cuda",
         "source": "dis_yolo_tpu_torch/csrc/assembly_bwd.cu",
         "replaces": "dis_yolo_tpu/ops/pallas_assembly.py:444",
         **path_launches("K3"), "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None},
        {"name": "K5 mask paste", "route": "cuda",
         "source": "dis_yolo_tpu_torch/csrc/paste.cu",
         "replaces": None, **path_launches("K5"),
         "max_abs_err": max(r["max_abs_err"] for r in k5),
         "ms": k5[2]["k5_ms"], "plain_ms": k5[2]["dense_ms"],
         "bound_ms": k5[2]["bound_ms"], "bound_by": k5[2]["bound_by"],
         "library_ms": None},
        {"name": "K4 score-map channel extraction", "route": "cuda",
         "source": "dis_yolo_tpu_torch/csrc/extract.cu",
         "replaces": "dis_yolo_tpu/ops/pallas_assembly.py:233",
         **path_launches("K4"), "max_abs_err": k4_err, "ms": k4["bf16"]["ms"],
         "plain_ms": k4["bf16"]["plain_ms"], "bound_ms": k4["bf16"]["bound"][0],
         "bound_by": k4["bf16"]["bound"][1],
         "library_ms": k4["bf16"]["library_ms"]},
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi_line,
                       "torch": torch.__version__, "threshold": thresh,
                       "launches_main_path": launches,
                       "launches_training_path": train_launches,
                       "timings_ms": timings,
                       "kernel_call_ms": per_call, "trace": trace,
                       "trace_train_step": train_trace,
                       "train_metrics": [{k: float(v) for k, v in m.items()}
                                         for m in metrics],
                       "f32_forward_rel_err": fwd_err,
                       "f32_train_card_vs_cpu": {
                           "total_loss_rel": loss_rel, "mask_loss_rel": mask_rel,
                           "scoremap_grad_rel": grad_err},
                       "train_assembly_grad_vs_gather_rel": grad_rel,
                       "k3_shapes": {"B": g_rois.shape[0], "R": g_rois.shape[1],
                                     "S": s3, "k": k3_k,
                                     "roi_pixels_inside": k3_inside},
                       "max_memory_allocated_gb": peak_all_gb,
                       "launches_serving_graphs_path": graph_launches,
                       "serving_graph_thresholds": g_thresh,
                       "serving_graph_checks_f32": graph_checks,
                       "serving_graph_traces": graph_traces,
                       "k4": {t: {"ms": v["ms"], "plain_ms": v["plain_ms"],
                                  "library_ms": v["library_ms"],
                                  "bound_ms": v["bound"][0],
                                  "bound_by": v["bound"][1]}
                              for t, v in k4.items()},
                       "serving_graph_memory_b2": memory,
                       "int8_calibration_absmax": absmax,
                       "ptxas": ptxas,
                       "k1_modes_and_sweep": k1_sweep,
                       "k2_sweep": k2_sweep, "k2_shape": k2_shape,
                       "k5_paste": k5,
                       "launches_eval_path": eval_launches,
                       "eval_path": eval_record, "eval_sweep": eval_sweep,
                       "eval_scoring": eval_scoring,
                       "trace_train_step_stage1": stage1_traces,
                       "launches_solver_path": solver_launches,
                       "solver_run": solver_record,
                       "solver_timing": solver_times,
                       "launches_device_data_path": dd_launches,
                       "device_data": dd_record,
                       "device_data_timing": dd_times,
                       "launches_parallel_path": dp_launches,
                       "parallel": dp_record,
                       "launches_export_path": export_launches,
                       "export_path": export_record,
                       "export_timing": export_times,
                       "seconds": time.time() - t_start,
                       "kernels": kernels},
                      f, indent=1)
    # checked last, so that a spill still leaves the run's measurements
    for name in ("nms", "assembly", "paste"):
        need(bool(ptxas[name]) and all(
            use.get("stack_frame") == 0 and use.get("spill_stores") == 0
            for use in ptxas[name].values()),
            f"{name}: ptxas reports a stack frame or spills: {ptxas[name]}")
    print(f"chip_smoke: all phases passed in {time.time() - t_start:.0f} s",
          flush=True)
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and evaluation paths on
one CUDA card and check them.

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
     against its default route;
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
training path, the serving graphs' path and the eval path, and
``launches_by_path``
holds each path's own count (each read from its run, with the counters
set to 0 just before it).  Only K4 has a single PyTorch call computing
the same function (``torch.empty(k*k,S,S).copy_(sm.permute(2,0,1))``);
``library_ms`` is null for the others.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import os
import re
import subprocess
import sys
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


def check_assembly(torch, cuda_assembly, gen, b, s, k, d, n_pad):
    """K1 vs its plain version on the card; returns max |diff| of probs."""
    sm = torch.randn((b, s, s, k * k), generator=gen).cuda()
    bx = random_boxes(torch, gen, b, d, n_pad).cuda()
    got = cuda_assembly.assemble_masks_batch_cuda(sm, bx, k, apply_sigmoid=False)
    want = cuda_assembly.assemble_masks_batch_plain(sm, bx, k, apply_sigmoid=False)
    torch.cuda.synchronize()
    need(torch.equal(got, want), f"K1 logits not bit-exact (S={s} k={k})")
    # the plain version on the card against the plain version on the CPU
    need(torch.equal(want.cpu(), cuda_assembly.assemble_masks_batch_plain(
        sm.cpu(), bx.cpu(), k, apply_sigmoid=False)),
        f"K1 plain logits differ between card and CPU (S={s} k={k})")
    got = cuda_assembly.assemble_masks_batch_cuda(sm, bx, k)
    want = cuda_assembly.assemble_masks_batch_plain(sm, bx, k)
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


def check_assembly_bwd(torch, cuda_assembly, mask_assembly, gen, b, s, k, r,
                       n_zero, check_grad, edit=None):
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
    fwd = cuda_assembly.assemble_masks_batch_cuda(sm, boxes, k, apply_sigmoid=False,
                                                  pixel_boxes=True)
    need(torch.equal(fwd, cuda_assembly.assemble_masks_batch_plain(
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


def check_planes(torch, cuda_assembly, gen, b, s, k, d, n_pad):
    """K1 on channel planes [B,k*k,S,S] equals K1 on the NHWC map bit for
    bit (logits and sigmoid), and the single-image ``use_extract`` route
    (K4 + K1 planes) equals the default route on bf16 and f32 maps."""
    sm = torch.randn((b, s, s, k * k), generator=gen).cuda()
    bx = random_boxes(torch, gen, b, d, n_pad).cuda()
    planes = sm.permute(0, 3, 1, 2).contiguous()
    for sig in (False, True):
        got = cuda_assembly.assemble_masks_batch_cuda(planes, bx, k, sig,
                                                      planes=True)
        want = cuda_assembly.assemble_masks_batch_cuda(sm, bx, k, sig)
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


def profile_window(torch, fn, calls, wall_ms):
    """One torch.profiler window of ``calls`` calls of ``fn``: device busy
    time per call, its idle share against ``wall_ms`` (the unprofiled
    time per call) and the top kernels."""
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
    return {"wall_us_per_call_profiled": wall_us,
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


def check_nms(torch, nms, cuda_nms, nms_fn, case, max_det, tag, min_kept=0,
              none_in=()):
    """K2 index-exact against its plain version on the card and on the CPU,
    by its default route and with the general route forced; images
    ``none_in`` must keep nothing.  Returns the picks and their max |diff|
    from the plain version's."""
    got = cuda_nms.nms_cuda(*case, max_det, 0.3)
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


def check_assembly_edges(torch, cuda_assembly, asm_fn, gen, b, s, k, d):
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
    want = cuda_assembly.assemble_masks_batch_plain(sm, bx, k, apply_sigmoid=False)
    need(torch.equal(want.cpu(), cuda_assembly.assemble_masks_batch_plain(
        sm.cpu(), bx.cpu(), k, apply_sigmoid=False)),
        f"K1 plain logits differ between card and CPU ({tag})")
    need(bool(want[:, 4].all()) and not bool(want[:, 8].any())
         and not bool(want[:, d - 3:].any()), f"K1 edge case not as built ({tag})")
    for name, got in (
            ("logits", cuda_assembly.assemble_masks_batch_cuda(sm, bx, k, False)),
            *((f"logits, launch {launch}", assembly_config(torch, asm_fn, sm, bx, k,
                                                           launch, False))
              for launch in K1_CONFIGS),
            ("planes logits", cuda_assembly.assemble_masks_batch_cuda(
                planes, bx, k, False, planes=True))):
        need(torch.equal(got, want), f"K1 {name} not bit-exact ({tag})")
    want_px = cuda_assembly.assemble_masks_batch_plain(sm, px, k, False, pixel_boxes=True)
    for name, got in (
            ("pixel-box logits", cuda_assembly.assemble_masks_batch_cuda(
                sm, px, k, False, pixel_boxes=True)),
            ("planes pixel-box logits", cuda_assembly.assemble_masks_batch_cuda(
                planes, px, k, False, pixel_boxes=True, planes=True))):
        need(torch.equal(got, want_px), f"K1 {name} not bit-exact ({tag})")
    got = cuda_assembly.assemble_masks_batch_cuda(sm, bx, k)
    probs = cuda_assembly.assemble_masks_batch_plain(sm, bx, k)
    torch.cuda.synchronize()
    need(torch.equal(got != 0, probs != 0), f"K1 support differs ({tag})")
    err = float((got - probs).abs().max())
    need(err <= 1e-6, f"K1 sigmoid error {err} > 1e-6 ({tag})")
    print(f"K1 {tag}: logits bit-exact in all three modes and every launch "
          f"shape, sigmoid max err {err:.3g}", flush=True)
    return err


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dis_yolo_tpu_torch.config import DISYoloConfig
    from dis_yolo_tpu_torch.models import api, fold, quant, s2d
    from dis_yolo_tpu_torch.ops import (_build, cuda_assembly, cuda_nms,
                                        mask_assembly, nms, paste)
    from dis_yolo_tpu_torch.train import train_step as ts
    from dis_yolo_tpu_torch.train.synthetic import synthetic_batch
    from dis_yolo_tpu_torch.losses.mask_loss import draw_uniforms
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
    k1_err = max(check_assembly(torch, cuda_assembly, gen, 2, 288, 3, 30, 5),
                 check_assembly(torch, cuda_assembly, gen, 1, 576, 3, 30, 3),
                 check_assembly(torch, cuda_assembly, gen, 1, 288, 5, 30, 3),
                 check_assembly(torch, cuda_assembly, gen, 1, 288, 7, 30, 3),
                 # odd S (rows off the 16-byte grid), S=576, k=5/7, boxes
                 # on the map's edges, 1-pixel, inverted and zero boxes
                 *(check_assembly_edges(torch, cuda_assembly, entries["assembly"],
                                        gen, b, s, k, 30)
                   for b, s, k in ((2, 145, 3), (1, 145, 5), (1, 145, 7),
                                   (1, 576, 3), (2, 288, 3))))
    k2_errs = [check_nms(torch, nms, cuda_nms, entries["nms"],
                         nms_case(torch, gen, b, kk), 30, f"K={kk} B={b}", kept)[1]
               for b, kk, kept in ((2, 512, 20), (1, 1024, 10), (1, 100, 10),
                                   # one warp, a ragged warp, one candidate,
                                   # the limit
                                   (3, 1, 0), (3, 31, 3), (3, 33, 3), (3, 1024, 30))]
    case = nms_knife_edge(torch, np)
    got, err = check_nms(torch, nms, cuda_nms, entries["nms"], case, 34, "knife edge")
    k2_errs.append(err)
    kept_second = int(((got >= 0) & (got % 2 == 1)).sum())
    need(0 < kept_second < 17, f"K2 knife edge not straddled: {kept_second}/17")
    print(f"K2 knife edge (IoU within 8 ulp of 0.3): {kept_second}/17 second "
          f"boxes kept", flush=True)
    # more rounds than valid candidates; a single round
    k2_errs.append(check_nms(torch, nms, cuda_nms, entries["nms"],
                             nms_case(torch, gen, 2, 64), 100, "K=64 B=2 max_det=100",
                             2)[1])
    k2_errs.append(check_nms(torch, nms, cuda_nms, entries["nms"],
                             nms_case(torch, gen, 2, 512), 1, "K=512 B=2 max_det=1",
                             2)[1])
    # scores in no order (the general route)
    case = nms_case(torch, gen, 2, 512)
    perm = torch.randperm(512, generator=gen).cuda()
    case = [t[:, perm].contiguous() for t in case]
    k2_errs.append(check_nms(torch, nms, cuda_nms, entries["nms"], case, 30,
                             "K=512 B=2 shuffled", 20)[1])
    # a valid -inf inside the list (image 0) and last (image 1)
    case = nms_case(torch, gen, 2, 512)
    case[1][0, 10], case[1][1, 511] = -float("inf"), -float("inf")
    case[3][:, 10], case[3][:, 511] = True, True
    k2_errs.append(check_nms(torch, nms, cuda_nms, entries["nms"], case, 30,
                             "K=512 B=2 valid -inf", 20)[1])
    # a valid NaN (image 0: nothing kept) and an invalid NaN (image 1: ignored)
    case = nms_case(torch, gen, 2, 512)
    case[1][:, 5] = float("nan")
    case[3][0, 5], case[3][1, 5] = True, False
    k2_errs.append(check_nms(torch, nms, cuda_nms, entries["nms"], case, 30,
                             "K=512 B=2 valid NaN / invalid NaN", 10, none_in=(0,))[1])
    k2_err = max(k2_errs)

    k3_cases = [check_assembly_bwd(torch, cuda_assembly, mask_assembly, gen,
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
        check_planes(torch, cuda_assembly, gen, b, s, k, 30, 3)
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

    cuda_assembly.assemble_masks_batch_cuda.launches = 0
    cuda_assembly.assemble_bwd_cuda.launches = 0
    cuda_nms.nms_cuda.launches = 0
    outs = {(b, k2): serve(model_k2 if k2 else model, b)
            for b in (1, 2) for k2 in (False, True)}
    torch.cuda.synchronize()
    launches = {"K1": cuda_assembly.assemble_masks_batch_cuda.launches,
                "K2": cuda_nms.nms_cuda.launches,
                "K3": cuda_assembly.assemble_bwd_cuda.launches}
    print(f"main path launches: {launches}", flush=True)
    need(launches["K1"] > 0 and launches["K2"] > 0,
         f"a kernel of the path never launched: {launches}")
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
    plain = cuda_assembly.assemble_masks_batch_plain(raws[3], dets32[..., :4],
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
    batch_np = synthetic_batch(tcfg, bsz, 3, seed=0)
    wire = dict(batch_np, images=(batch_np["images"] * 255).astype(np.uint8))
    wire["masks_packed"] = np.packbits(
        wire.pop("true_masks").reshape(bsz, n_gt, -1), axis=-1)
    tbatch = {k: torch.from_numpy(v).cuda() for k, v in wire.items()}
    trainer1 = api.create_model(tcfg)
    trainer1.load_state_dict(model.state_dict())
    trainer2 = api.create_model(tcfg.replace(locked_layers=()))
    keys = [k for k in trainer1.state_dict() if "num_batches_tracked" not in k]
    sd0 = {k: v.clone() for k, v in trainer1.state_dict().items()}
    state1, step1 = ts.init_train_state(trainer1), ts.make_train_step(trainer1)
    gen_t = torch.Generator().manual_seed(1)

    cuda_assembly.assemble_masks_batch_cuda.launches = 0
    cuda_assembly.assemble_bwd_cuda.launches = 0
    cuda_nms.nms_cuda.launches = 0
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
    train_launches = {"K1": cuda_assembly.assemble_masks_batch_cuda.launches,
                      "K2": cuda_nms.nms_cuda.launches,
                      "K3": cuda_assembly.assemble_bwd_cuda.launches}
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
    cuda_assembly.assemble_masks_batch_cuda.launches = 0
    cuda_assembly.assemble_bwd_cuda.launches = 0
    cuda_assembly.extract_planes_cuda.launches = 0
    cuda_nms.nms_cuda.launches = 0
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
    graph_launches = {"K1": cuda_assembly.assemble_masks_batch_cuda.launches,
                      "K2": cuda_nms.nms_cuda.launches,
                      "K3": cuda_assembly.assemble_bwd_cuda.launches,
                      "K4": cuda_assembly.extract_planes_cuda.launches}
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
    cuda_assembly.assemble_masks_batch_cuda.launches = 0
    cuda_assembly.assemble_bwd_cuda.launches = 0
    cuda_assembly.extract_planes_cuda.launches = 0
    cuda_nms.nms_cuda.launches = 0
    eval_record, eval_ctx = eval_phase(np, torch, em, cfg, model.state_dict())
    torch.cuda.synchronize()
    eval_launches = {"K1": cuda_assembly.assemble_masks_batch_cuda.launches,
                     "K2": cuda_nms.nms_cuda.launches,
                     "K3": cuda_assembly.assemble_bwd_cuda.launches,
                     "K4": cuda_assembly.extract_planes_cuda.launches}
    print(f"eval path launches: {eval_launches}", flush=True)
    need(eval_launches["K1"] > 0 and eval_launches["K2"] > 0,
         f"a kernel of the eval path never launched: {eval_launches}")
    print("eval path: " + json.dumps(eval_record), flush=True)
    print(f"eval path done at {time.time() - t_start:.0f} s", flush=True)

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
    k1 = lambda: cuda_assembly.assemble_masks_batch_cuda(*k1_args, **k1_kw)
    k1_plain_fn = lambda: cuda_assembly.assemble_masks_batch_plain(*k1_args, **k1_kw)
    k2 = lambda: cuda_nms.nms_cuda(*k2_args, **k2_kw)
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
        torch, lambda: cuda_nms.nms_cuda(*k2_args[:4], 1, k2_args[5]))
    per_call["K2_per_round_device"] = ((k2_ms - per_call["K2_one_round_device"])
                                       / (max_det - 1))
    print("kernel ms per call incl. the host's wrapper and launch, and K2's one "
          "round and per round: " + json.dumps(per_call), flush=True)

    def k1_bound_of(scoremaps, boxes, k_):
        out_px = boxes.shape[0] * boxes.shape[1] * scoremaps.shape[2] ** 2
        return bound(scoremaps.numel() * 4 + boxes.numel() * 4 + out_px * 4,
                     out_px * (6 + 2 * (k_ - 1)))

    k1_bound = k1_bound_of(sm, bx, k)
    picked = cuda_nms.nms_cuda(*k2_args, **k2_kw)
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
                   (cuda_assembly, "assemble_masks_batch_cuda")):
        step2(state2, tbatch, gen_t)
    (k3_args, _), (k1t_args, k1t_kw) = (captured["assemble_bwd_cuda"],
                                        captured["assemble_masks_batch_cuda"])
    roi_px, g_rois, k3_k = k3_args
    k3 = lambda: cuda_assembly.assemble_bwd_cuda(*k3_args)
    k3_plain_fn = lambda: mask_assembly.assemble_bwd_plain(*k3_args)
    k3_ms, k3_plain = graph_ms(torch, k3), graph_ms(torch, k3_plain_fn)
    per_call["K1_train_pixel_boxes_device"] = graph_ms(
        torch, lambda: cuda_assembly.assemble_masks_batch_cuda(*k1t_args, **k1t_kw))
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
        torch, lambda: cuda_assembly.assemble_masks_batch_cuda(
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
                   "eval": eval_launches[name]}
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
                       "launches_eval_path": eval_launches,
                       "eval_path": eval_record, "eval_sweep": eval_sweep,
                       "eval_scoring": eval_scoring,
                       "trace_train_step_stage1": stage1_traces,
                       "seconds": time.time() - t_start,
                       "kernels": kernels},
                      f, indent=1)
    # checked last, so that a spill still leaves the run's measurements
    for name in ("nms", "assembly"):
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

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card and check it.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits non-zero before the last line is printed):

  1. device and build: the card's name, count and power limit; build the
     hand-written kernels of ``dis_yolo_tpu_torch/csrc`` with nvcc for
     sm_90a (one nvcc per source, all started together);
  2. each kernel against its plain PyTorch version, on the card, at the
     main path's shapes: K1 (mask assembly) logits bit-exact and sigmoid
     within 1e-6 inside the box, exact 0 outside, at S=288 (B=2, D=30,
     padding rows), S=576 and k=5/7; K2 (NMS) index-exact at K=512, B=2,
     with mixed classes, forced score ties and overlapping boxes (and at
     K=1024 and K=100, the shared-memory and ragged-word edges);
  3. the slice: the full-width 576^2 model (Darknet-53, 3 heads, stride-2
     decoder, bf16 compute, seeded random weights) through ``predict`` +
     ``paste_masks_batch`` at B=1 and B=2, with the defaults (K1) and with
     ``use_pallas_nms`` (K1+K2): identical outputs, 30 detections in image
     0, launch counters > 0; then the float32 path (TF32 off) against the
     CPU forward and against the plain assembly on the same raw outputs;
  4. timing with CUDA events: forward, predict and predict+paste ms at
     576^2 B=1 and B=2; each kernel and its plain version on the main
     path's captured inputs, as device time per call from CUDA-graph
     replays (hot L2: the inputs were just written, as on the main path),
     beside its bound; one torch.profiler window of predict + paste at
     B=1 for the device's busy time, its idle share and the top kernels.

The last lines are the card's ``nvidia-smi`` name and power limit, one
``{"kernels": [...]}`` JSON line and ``{"ok": true, "device": {...}}``.
Neither kernel has a single PyTorch call computing the same function, so
``library_ms`` is null for both.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

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
    for kind, keys in (("K1 assembly", ("assembly_kernel",)),
                       ("K2 nms", ("nms_kernel",)),
                       ("batchnorm", ("bn_fw",)),
                       ("conv/gemm", ("xmma", "conv", "gemm", "cutlass")),
                       ("elementwise", ("elementwise",)),
                       ("reduce/sort/scan", ("reduce", "sort", "radix", "scan"))):
        if any(k in n for k in keys):
            return kind
    return "other"


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
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.ops import _build, cuda_assembly, cuda_nms, nms, paste
    from dis_yolo_tpu_torch.utils.runtime import calibrate_threshold

    # ---- phase 1: device and build ------------------------------------
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
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            info = [ln.strip() for ln in log.read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"  {name}: " + " | ".join(info[-2:]), flush=True)

    # ---- phase 2: kernels against their plain versions ----------------
    gen = torch.Generator().manual_seed(0)
    k1_err = max(check_assembly(torch, cuda_assembly, gen, 2, 288, 3, 30, 5),
                 check_assembly(torch, cuda_assembly, gen, 1, 576, 3, 30, 3),
                 check_assembly(torch, cuda_assembly, gen, 1, 288, 5, 30, 3),
                 check_assembly(torch, cuda_assembly, gen, 1, 288, 7, 30, 3))
    k2_err = 0.0
    for b, kk in ((2, 512), (1, 1024), (1, 100)):   # 1024: >48 KB shared
        case = nms_case(torch, gen, b, kk)
        got = cuda_nms.nms_cuda(*case, 30, 0.3)
        want = nms._select_suppress_nms(*case, 0.3, 30)
        want_cpu = nms._select_suppress_nms(*(t.cpu() for t in case), 0.3, 30)
        torch.cuda.synchronize()
        need(torch.equal(got, want), f"K2 K={kk} not index-exact:\n{got}\n{want}")
        need(torch.equal(want.cpu(), want_cpu), f"K2 K={kk} plain differs card vs CPU")
        need(bool((got >= 0).sum() >= 10 * b), f"K2 K={kk} kept too few boxes")
        k2_err = max(k2_err, float((got - want).abs().max()))
        print(f"K2 K={kk} B={b}: index-exact, {int((got >= 0).sum())} kept",
              flush=True)

    case = nms_knife_edge(torch, np)
    got = cuda_nms.nms_cuda(*case, 34, 0.3)
    want = nms._select_suppress_nms(*case, 0.3, 34)
    kept_second = int(((got >= 0) & (got % 2 == 1)).sum())
    need(torch.equal(got, want), f"K2 knife edge not index-exact:\n{got}\n{want}")
    need(0 < kept_second < 17, f"K2 knife edge not straddled: {kept_second}/17")
    print(f"K2 knife edge (IoU within 8 ulp of 0.3): index-exact, "
          f"{kept_second}/17 second boxes kept", flush=True)

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

    def serve(m, b):
        dets, masks = api.predict(m, images[b], windows[b], thresh)
        return (dets, masks) + paste.paste_masks_batch(masks, dets, size, size, size)

    cuda_assembly.assemble_masks_batch_cuda.launches = 0
    cuda_nms.nms_cuda.launches = 0
    outs = {(b, k2): serve(model_k2 if k2 else model, b)
            for b in (1, 2) for k2 in (False, True)}
    torch.cuda.synchronize()
    launches = {"K1": cuda_assembly.assemble_masks_batch_cuda.launches,
                "K2": cuda_nms.nms_cuda.launches}
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
    print("timings " + json.dumps(timings), flush=True)

    # where the time goes: one traced window of predict + paste at B=1
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            serve(model, 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / 3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device) / 3
    by_kind, top = {}, {}
    for e in device:
        kind_ = kernel_kind(e.key)
        by_kind[kind_] = by_kind.get(kind_, 0.0) + e.self_device_time_total / 3
        top[e.key[:100]] = top.get(e.key[:100], 0.0) + e.self_device_time_total / 3
    trace = {"wall_us_per_call_profiled": wall_us,
             "device_busy_us_per_call": busy_us if device else "not measured",
             # the profiler slows the host, so the idle share is taken
             # against the unprofiled predict+paste time of phase 4
             "device_idle_share": (1 - busy_us / (timings["predict_paste_ms_b1"] * 1e3)
                                   if device else "not measured"),
             "kernel_launches_per_call": sum(e.count for e in device) / 3,
             "device_us_by_kind": by_kind,
             "top_kernels_us_per_call": dict(sorted(top.items(),
                                                    key=lambda kv: -kv[1])[:10])}
    print("trace predict+paste B=1: " + json.dumps(trace), flush=True)

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
    # K2 with a single selection round: the K x K bitmask build alone
    per_call["K2_build_only_device"] = graph_ms(
        torch, lambda: cuda_nms.nms_cuda(*k2_args[:4], 1, k2_args[5]))
    print("kernel ms per call incl. the host's wrapper and launch, and K2's build: "
          + json.dumps(per_call), flush=True)
    out_px = bx.shape[0] * bx.shape[1] * sm.shape[1] * sm.shape[2]
    k1_bound = bound(sm.numel() * 4 + bx.numel() * 4 + out_px * 4,
                     out_px * (6 + 2 * (k - 1)))
    picked = cuda_nms.nms_cuda(*k2_args, **k2_kw)
    kk = k2_args[1].shape[1]
    # greedy NMS needs one row of pair tests per winner and one argmax
    # over K per round (the kernel stops after the round that finds none)
    winners = int((picked >= 0).sum())
    rounds = int(torch.clamp((picked >= 0).sum(-1) + 1, max=picked.shape[1]).sum())
    k2_bound = bound(k2_args[1].numel() * (16 + 4 + 4 + 1) + picked.numel() * 8,
                     winners * kk * NMS_OPS_PER_PAIR + rounds * kk * 2)
    print(f"K1 S={sm.shape[1]} D={bx.shape[1]}: {k1_ms * 1e3:.1f} us "
          f"(plain {k1_plain * 1e3:.1f} us, bound {k1_bound[0] * 1e3:.2f} us "
          f"by {k1_bound[1]}); K2 K={kk}: {k2_ms * 1e3:.1f} us (plain "
          f"{k2_plain * 1e3:.1f} us, bound {k2_bound[0] * 1e3:.3f} us by "
          f"{k2_bound[1]})", flush=True)

    kernels = [
        {"name": "K1 mask assembly + sigmoid", "route": "cuda",
         "source": "dis_yolo_tpu_torch/csrc/assembly.cu",
         "replaces": "dis_yolo_tpu/ops/pallas_assembly.py:276",
         "launches": launches["K1"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "K2 class-aware greedy NMS", "route": "cuda",
         "source": "dis_yolo_tpu_torch/csrc/nms.cu",
         "replaces": "dis_yolo_tpu/ops/pallas_nms.py:73",
         "launches": launches["K2"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi_line,
                       "torch": torch.__version__, "threshold": thresh,
                       "launches_main_path": launches, "timings_ms": timings,
                       "kernel_call_ms": per_call, "trace": trace,
                       "f32_forward_rel_err": fwd_err, "kernels": kernels},
                      f, indent=1)
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()

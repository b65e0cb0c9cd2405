"""Batched serving of inspection photos: one client, one batch in flight.

Each batch holds ``batch`` photos of one original size, letterboxed to
the network's input in set-up and held in pinned host memory; batches
alternate the traffic's sizes, in an order drawn from the seed.  The
timed path for a batch, from taking it to its results on the host:

  h2d                   the batch to the card
  forward               ``api.forward`` (the network; ``api.predict`` is
                        this and the next step)
  predict_from_outputs  decode, NMS, the degenerate-box drop, K1's masks
  paste                 ``paste.paste_masks_batch`` at the photo's size
  fetch                 detections [B, D, 6] and the semantic map
                        [B, H0, W0] uint8 to the host; the per-instance
                        masks stay on the card

Each step is a ``record_function`` span.  The detection threshold is
part of the traffic: the rule of the port's ``calibrate_threshold``,
applied per photo to the reference's forward of the whole pool, so that
every photo keeps at least ``min_survivors`` detections; both sides get
it.

Correctness, on the window's last batch of each size (the answers due
when it closes), kept on the card through the window and judged after
it once the program is freed:

  raw_err     the network's four raw outputs (three heads, score maps)
              against the reference's forward of the same photos: the
              quadratic mean of the four relative L2 errors, so one
              output all wrong (relative error 1) reads 0.5 or more
  det_diff    detections the reference's decode and NMS make of the
              program's own raw outputs, against the program's
              detections on the card and as fetched: values that differ
  mask_diff   K1's masks against the reference's assembly of the
              program's score maps at the program's boxes: values that
              differ
  paste_diff  the reference's paste of the program's masks and
              detections against the program's pasted masks, valid flags
              and fetched semantic map: values that differ
"""

from __future__ import annotations

import gc
import math
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from port_bench import harness, photos, trace as tracing, work
from port_bench.reference import plain_float32
from port_bench.reference import net as ref_net
from port_bench.reference import post as ref_post
from port_bench.weights import make_weights, program_state_dict


def _cfg(config: dict):
    from dis_yolo_tpu_torch.config import DISYoloConfig
    fields = dict(config["config"])
    fields["classes"] = tuple(fields["classes"])
    fields["anchors"] = tuple(tuple(a) for a in fields["anchors"])
    return DISYoloConfig(**fields)


def _specs(cfg):
    return ref_net.layer_specs(cfg.image_size, cfg.mask_stride,
                               cfg.num_class, cfg.k_map,
                               cfg.anchors_per_scale)


class Pool:
    """The letterboxed photos as ``batches`` distinct batches of one size
    each, and the order the window takes them in."""

    def __init__(self, traffic: dict, net: int, seed: int, device):
        sizes = [tuple(s) for s in traffic["sizes"]]
        b = traffic["batch"]
        per_size = traffic["pool"] // len(sizes)
        made = photos.make_photos(seed, sizes, per_size,
                                  traffic["max_defects"], device)
        rng = np.random.default_rng([seed, 3])
        self.images: List[torch.Tensor] = []     # host, pinned on CUDA
        self.windows: List[torch.Tensor] = []    # on the device
        self.sizes: List[tuple] = []
        by_size = []
        for hw in sizes:
            boxed, window = photos.letterbox(made[hw]["photos"], net)
            perm = rng.permutation(per_size)
            ids = []
            for j in range(per_size // b):
                x = boxed[torch.as_tensor(perm[j * b:(j + 1) * b],
                                          device=boxed.device)]
                self.images.append(x.cpu().pin_memory() if x.is_cuda
                                   else x.cpu())
                self.windows.append(torch.as_tensor(
                    np.tile(window, (b, 1)), device=device))
                self.sizes.append(hw)
                ids.append(len(self.images) - 1)
            by_size.append(ids)
            del boxed
        # batches alternate the sizes; each size's batches in a seeded
        # order, so the first len(images) positions hold each batch once
        for ids in by_size:
            rng.shuffle(ids)
        self.order = [ids[j] for j in range(len(by_size[0]))
                      for ids in by_size]

    def at(self, position: int) -> int:
        return self.order[position % len(self.order)]


def per_image_threshold(score: np.ndarray, cls: np.ndarray,
                        boxes: np.ndarray, iou_thresh: float,
                        min_survivors: int) -> float:
    """The port's calibration rule for one photo: walk the candidates in
    score order through greedy class-aware NMS and stop at the
    ``min_survivors``-th survivor.  Returns a threshold halfway between
    that survivor's score and the next lower candidate's, so the strict
    ``score > threshold`` keeps exactly those survivors' candidates."""
    order = np.argsort(-score, kind="stable")
    kept = []
    for n, i in enumerate(order):
        a = boxes[i]
        ok = True
        for j in kept:
            if cls[j] != cls[i]:
                continue
            b = boxes[j]
            ih = min(a[2], b[2]) - max(a[0], b[0])
            iw = min(a[3], b[3]) - max(a[1], b[1])
            if ih <= 0 or iw <= 0:
                continue
            inter = ih * iw
            union = ((a[2] - a[0]) * (a[3] - a[1])
                     + (b[2] - b[0]) * (b[3] - b[1]) - inter)
            if union > 0 and inter / union > iou_thresh:
                ok = False
                break
        if ok:
            kept.append(i)
            if len(kept) >= min_survivors:
                nxt = score[order[n + 1]] if n + 1 < len(order) else 0.0
                return float(0.5 * (score[i] + nxt))
    return 0.0


def calibrate(ref_raws, windows, cfg, min_survivors: int) -> float:
    """The threshold for the pool: the lowest of its photos' own."""
    conf, prob, coord = ref_post.candidates(ref_raws, cfg.anchors_array())
    class_max, cls = torch.max(prob, dim=-1)
    score = (conf * class_max).cpu().numpy()
    boxes = ref_post.clip_boxes(ref_post.cxcywh_to_yxyx(coord),
                           windows.float()).cpu().numpy()
    cls = cls.cpu().numpy()
    return min(per_image_threshold(score[i], cls[i], boxes[i],
                                   cfg.iou_threshold, min_survivors)
               for i in range(score.shape[0]))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape:
        return math.inf
    d = (got.double() - want.double()).norm()
    return float(d / want.double().norm().clamp_min(1e-30))


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a.cpu() != b.cpu()).sum())


def _to(obj, device):
    """A batch's outputs (tensors, tuples and dicts of them) moved to
    ``device``; anything else as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    return obj


def judge(kept: dict, ref_raws, window, cfg, threshold: float,
          hw) -> Dict[str, float]:
    """The checks of one retained batch (the module docstring), and
    ``raw_err``'s four parts, one per output."""
    per_output = [_rel_l2(p.float(), r)
                  for p, r in zip(kept["raws"], ref_raws)]
    raw_err = math.sqrt(sum(e * e for e in per_output) / len(per_output))
    ref_dets = ref_post.detections(kept["raws"], window, threshold,
                                   cfg.anchors_array(), cfg.iou_threshold,
                                   cfg.max_detection, cfg.pre_nms_top_k)
    det_diff = _differ(kept["dets"], ref_dets) + _differ(kept["dets_h"],
                                                         ref_dets)
    masks = kept["masks"]
    mask_diff = _differ(masks, ref_post.assemble(kept["raws"][3],
                                                 kept["dets"][..., :4],
                                                 cfg.k_map))
    full, valid, sem = ref_post.paste(masks, kept["dets"], hw[0], hw[1],
                                      cfg.image_size)
    paste_diff = (_differ(kept["full"], full) + _differ(kept["valid"], valid)
                  + _differ(kept["sem_h"], sem))
    return {"raw_err": raw_err, "det_diff": det_diff, "mask_diff": mask_diff,
            "paste_diff": paste_diff,
            **{f"raw_err.{name}": e for name, e in
               zip(("s8", "s16", "s32", "maps"), per_output)}}


class Server:
    """The port's serving path over one pool: the system under test."""

    def __init__(self, cfg, model, pool: Pool, threshold: float, device):
        from dis_yolo_tpu_torch.models import api
        from dis_yolo_tpu_torch.ops import paste
        self.api, self.paste = api, paste
        self.cfg, self.model, self.pool = cfg, model, pool
        self.threshold, self.device = threshold, torch.device(device)

    def batch(self, b: int) -> dict:
        from torch.profiler import record_function
        api, cfg, dev = self.api, self.cfg, self.device
        h0, w0 = self.pool.sizes[b]
        with record_function("h2d"):
            x = self.pool.images[b].to(dev, non_blocking=True)
        with record_function("forward"):
            raws = api.forward(self.model, x, dev)
        with record_function("predict_from_outputs"):
            dets, masks = api.predict_from_outputs(
                cfg, raws, self.pool.windows[b], self.threshold, dev)
        with record_function("paste"):
            full, valid, sem = self.paste.paste_masks_batch(
                masks, dets, h0, w0, cfg.image_size)
        with record_function("fetch"):
            dets_h = dets.cpu()
            sem_h = sem.cpu()
        return {"raws": raws, "dets": dets, "masks": masks, "full": full,
                "valid": valid, "dets_h": dets_h, "sem_h": sem_h,
                "batch": b}


def build_model(cfg, weights, graph: str, pool: Pool, device):
    """The port's model on ``device`` with the benchmark's weights:
    ``graph`` "default" is the configuration as stated; "int8" is the
    port's own int8 serving graph (``quant``), calibrated on the pool's
    first batch, the control of the correctness check."""
    from dis_yolo_tpu_torch.models import api
    sd = program_state_dict(weights)
    if graph == "default":
        model = api.create_model(cfg, device)
        model.load_state_dict(sd)
        return model
    if graph != "int8":
        raise ValueError(f"unknown graph {graph!r}")
    from dis_yolo_tpu_torch.models import fold, quant
    dsd = fold.deploy_variables(sd)
    calib = pool.images[pool.order[0]].to(device)
    absmax = quant.calibrate_deploy(
        api.create_model(cfg.replace(quant=True, quant_calibrate=True),
                         device), dsd, calib)
    qcfg = cfg.replace(quant=True)
    model = api.create_model(qcfg, device)
    model.load_state_dict(quant.quantize_deploy(dsd, absmax))
    return model


def count_syncs(server: Server, positions) -> float:
    """Host syncs per batch, counted by PyTorch's sync debug mode."""
    n = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for p in positions:
                server.batch(server.pool.at(p))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            n += 1
    return n / max(len(positions), 1)


def run(ctx: harness.Context, graph: str = "default") -> harness.Outcome:
    clock, traffic, dev = ctx.clock, ctx.traffic, ctx.device
    cuda = torch.device(dev).type == "cuda"
    plain_float32()
    cfg = _cfg(ctx.config)
    # the port's import, timed apart from the load of its kernel
    from dis_yolo_tpu_torch.models import api  # noqa: F401
    from dis_yolo_tpu_torch.ops import _build
    clock.mark("import_port")
    if cuda:
        _build.load("assembly")
    clock.mark("kernels")
    pool = Pool(traffic, cfg.image_size, ctx.seed, dev)
    clock.mark("pool")
    specs = _specs(cfg)
    first = pool.images[pool.order[0]].to(dev)
    weights = make_weights(specs, ctx.seed, dev, first)
    clock.mark("weights")

    # the threshold, from the reference's forward of the whole pool
    ref = ref_net.Net(specs, weights)
    heads = [ref(pool.images[b].to(dev))[:3] for b in range(len(pool.images))]
    threshold = calibrate([torch.cat([h[i] for h in heads])
                           for i in range(3)] + [None],
                          torch.cat(pool.windows), cfg,
                          traffic["min_survivors"])
    del heads, ref
    clock.mark("threshold")

    n_sizes = len(traffic["sizes"])
    model = build_model(cfg, weights, graph, pool, dev)
    # the reference's copy, off the card until the window has closed
    weights = {k: v.cpu() for k, v in weights.items()}
    del first
    server = Server(cfg, model, pool, threshold, dev)
    clock.mark("model")
    # the warm-up holds the newest batch of each size, as the window
    # does, so the allocator has the window's blocks before it starts
    warm = {}
    for b in range(len(pool.images)):
        warm[pool.sizes[b]] = server.batch(b)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    del warm
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    clock.mark("warmup")

    # ---- the window
    setup_s = clock.total()
    lat: List[float] = []
    kept: Dict[tuple, dict] = {}     # the newest batch of each size
    attempted = failed = images = kept_rows = 0
    # one host thread, and set-up's objects out of the collector's reach:
    # sets of 30-s runs spread 3-5% (img/s) and 4-7% (p95) so, against
    # 6-7% and 8-14% with PyTorch's thread pool and the whole collector
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()
    t_start = time.perf_counter()
    i = 0
    while True:
        b = pool.at(i)
        attempted += 1
        t0 = time.perf_counter()
        try:
            out = server.batch(b)
        except RuntimeError as exc:      # a failed batch counts, and ends
            failed += 1
            print(f"port_bench: batch {i} failed: {exc}")
            break
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        images += traffic["batch"]
        kept_rows += int((out["dets_h"][..., 5] > 0).sum())
        kept[pool.sizes[b]] = out
        del out
        i += 1
        if t1 - t_start >= ctx.seconds and len(kept) == n_sizes:
            break
    window_s = time.perf_counter() - t_start
    peak = held = 0
    if cuda:
        # the kept batches, to the host: what that frees is what keeping
        # them added to every batch's peak once both were held
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        kept = {hw: _to(out, "cpu") for hw, out in kept.items()}
        held -= torch.cuda.memory_allocated()
    e2e = {"serve_img_per_s": images / window_s,
           "serve_batch_p95_ms": (float(np.percentile(lat, 95)) * 1e3
                                  if lat else math.inf),
           "peak_mem_gib": (peak - held) / 2 ** 30, "setup_s": setup_s}
    counters = {"batches": float(len(lat)), "images_per_batch":
                float(traffic["batch"]), "rate_img_per_s": images / window_s,
                "flops_per_image": work.forward_flops(specs, cfg.image_size,
                                                      cfg.mask_stride),
                "threshold": threshold, "kept_bytes": float(held),
                "batch_p50_ms": (float(np.percentile(lat, 50)) * 1e3
                                 if lat else math.inf),
                "detections_per_image": kept_rows / max(images, 1)}

    # ---- the traced sub-window and the sync count, after the window
    traces: list = []
    if ctx.trace and cuda:
        n = traffic["profile_batches"]
        pasted = []
        with tracing.profiled(n, traces):
            for p in range(i, i + n):
                b = pool.at(p)
                out = server.batch(b)
                pasted.append((b, out["dets_h"]))
                del out
        counters["syncs_per_batch"] = count_syncs(
            server, range(i + n, i + n + traffic["sync_batches"]))
        nbytes = ops = 0.0
        for b, dets_h in pasted:
            h0, w0 = pool.sizes[b]
            box_px = ref_post.original_boxes(dets_h[..., :4], h0, w0,
                                             cfg.image_size)
            valid = (dets_h[..., 5] > 0) & (
                (box_px[..., 2] - box_px[..., 0])
                * (box_px[..., 3] - box_px[..., 1]) > 0)
            bb, oo = work.paste_work(
                [tuple(int(v) for v in row) for row in box_px[valid]],
                dets_h.shape[0], h0, w0, cfg.mask_size)
            nbytes, ops = nbytes + bb, ops + oo
        counters["paste_bound_s"] = work.roofline_s(nbytes, ops)[0]
        # K1 runs once a batch, on the boxes the batch fetched
        counters["k1_bound_s_per_call"] = sum(
            work.roofline_s(*work.k1_work(dets_h[..., :4].numpy(),
                                          cfg.mask_size, cfg.k_map))[0]
            for _, dets_h in pasted) / len(pasted)

    gc.unfreeze()
    torch.set_num_threads(threads)

    # ---- correctness, with the program freed
    del server, model
    if cuda:
        torch.cuda.empty_cache()
    ref = ref_net.Net(specs, {k: v.to(dev) for k, v in weights.items()})
    checks_by_name: Dict[str, float] = {}
    for hw in list(kept):
        b = kept[hw].pop("batch")
        got = judge(_to(kept.pop(hw), dev), ref(pool.images[b].to(dev)),
                    pool.windows[b], cfg, threshold, hw)
        for k, v in got.items():
            checks_by_name[k] = max(checks_by_name.get(k, 0.0), v)
    checks = [(k, checks_by_name.get(k, math.inf), ctx.limits[k])
              for k in ctx.limits]
    counters["judged"] = {k: v for k, v in checks_by_name.items()
                          if k not in ctx.limits}
    return harness.Outcome(e2e=e2e, attempted=attempted, failed=failed,
                           memory_peak_bytes=int(peak), checks=checks,
                           counters=counters,
                           trace=traces[0] if traces else None)

"""Batched serving through the port's int8 serving graph (``quant``).

The model is built as the port's users get it from ``cli infer --quant
--quant-calib max`` and ``export --quant``: the benchmark's weights
folded (``models/fold.deploy_variables``), the absmax of every int8
layer's input over the pool's first batch (``quant.calibrate_deploy`` on
the ``quant_calibrate`` graph), the int8 weights and scales
(``quant.quantize_deploy``), then ``api.create_model`` of the
configuration.  It is served as ``drivers/serve.py`` serves the default
graph, through the same ``Server`` (``api.forward``,
``api.predict_from_outputs``, ``paste.paste_masks_batch``), pool, window
and traced sub-window; this module borrows those helpers.

The threshold is the same rule applied to the int8 reference's forward
of the pool, at the program's calibration and from the program's stem
outputs (as ``raw_err`` below), so that every photo fills its
``min_survivors`` slots in the int8 outputs.

Correctness, on the window's last batch of each size.  After the
window, one more forward of each judged batch with hooks on the stem
(layers 1-4, bfloat16) hands the reference the program's own outputs of
those layers (``reference/quant.py`` says why it needs them):

  raw_err     the four raw outputs against the int8 reference run with
              the program's activation scales (its calibration, a
              decision the reference follows as ``det_diff`` follows
              NMS) from the program's stem outputs: the quadratic mean
              of the four relative L2 errors
  stem_err    the reference's own output of each stem layer, on the
              program's input to it, against the program's: the worst
              layer's relative L2 error
  scale_err   the activation scales the program's int8 layers hold
              against the reference's own calibration: the worst
              layer's relative gap
  f32_err     the four raw outputs against the float32 reference
              (``reference/net.py``), as ``raw_err``: the int8 graph's
              accuracy band
  det_diff, mask_diff, paste_diff
              as in ``drivers/serve.py``, on the program's own outputs a
              stage on

Judged, not checked (``counters["judged"]``): ``rerun_diff``, the values
of the four raw outputs in which the second forward differs from the
window's, and ``raw_err_free``, ``raw_err`` with the reference's own
stem.

``run(ctx, graph)`` takes, besides the configuration as stated
("default"), the control and two faults that set the limits
(``python -m port_bench.control --graphs default,scales_x2,...``):
``scales_x2`` every activation scale doubled (inputs quantized at 7
bits), ``fault_scale`` one layer's scale doubled, ``fault_bias`` one
layer's dequant bias dropped; each is made after the calibration, which
the reference follows.

With ``--trace 1`` the traced block also takes the program's own window
(``program_trace.program_window``: the spans ``dis_yolo.quant.*`` and
the ``quant.*`` counters), kept as ``counters["program"]``.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import harness, program_trace, trace as tracing, work
from port_bench import work_int8
from port_bench.drivers import serve
from port_bench.reference import net as ref_net
from port_bench.reference import plain_float32
from port_bench.reference import post as ref_post
from port_bench.reference import quant as ref_quant
from port_bench.weights import make_weights, program_state_dict

GRAPHS = ("default", "scales_x2", "fault_scale", "fault_bias")
FAULT_LAYER = "convolutional27"


def _cfg(config: dict):
    """``drivers/serve.py``'s configuration, ``quant_layers`` as a tuple."""
    fields = dict(config["config"])
    layers = fields.pop("quant_layers", None)
    cfg = serve._cfg({**config, "config": fields})
    return cfg if layers is None else cfg.replace(
        quant_layers=tuple(layers))


def build_model(cfg, weights, graph: str, calib: torch.Tensor, device):
    """The port's int8 model and the absmax its calibration found, by
    layer name (the module docstring)."""
    from dis_yolo_tpu_torch.models import api, fold, quant
    if graph not in GRAPHS:
        raise ValueError(f"unknown graph {graph!r}")
    dsd = fold.deploy_variables(program_state_dict(weights))
    absmax = quant.calibrate_deploy(
        api.create_model(cfg.replace(quant_calibrate=True), device), dsd,
        calib)
    used = dict(absmax)
    if graph == "scales_x2":
        used = {k: 2.0 * v for k, v in used.items()}
    elif graph == "fault_scale":
        used[FAULT_LAYER] *= 2.0
    sd = quant.quantize_deploy(dsd, used)
    if graph == "fault_bias":
        sd[f"{FAULT_LAYER}.bias"].zero_()
    model = api.create_model(cfg, device)
    model.load_state_dict(sd)
    return model, absmax


def held_scales(model) -> Dict[str, float]:
    """The activation scale each int8 layer of ``model`` quantizes with,
    as the absmax it stands for (``127 / inv_sx``)."""
    return {name: 127.0 / float(mod.inv_sx)
            for name, mod in model.named_children()
            if hasattr(mod, "inv_sx")}


def quad_rel(raws, ref_raws):
    """The quadratic mean of the four outputs' relative L2 errors, and
    the four."""
    per_output = [serve._rel_l2(p.float(), r.to(p.device))
                  for p, r in zip(raws, ref_raws)]
    return (math.sqrt(sum(e * e for e in per_output) / len(per_output)),
            per_output)


def judge(kept: dict, ref_raws, f32_raws, window, cfg, threshold: float,
          hw) -> Dict[str, float]:
    """``drivers/serve.py``'s checks of one retained batch against the int8
    reference's raw outputs, and ``f32_err`` with its four parts."""
    got = serve.judge(kept, ref_raws, window, cfg, threshold, hw)
    got["f32_err"], per_output = quad_rel(kept["raws"], f32_raws)
    for name, e in zip(("s8", "s16", "s32", "maps"), per_output):
        got[f"f32_err.{name}"] = e
    return got


def stem_outputs(model, images, layers, device, to="cpu"):
    """The program's outputs of ``layers`` (NCHW) and its raw outputs,
    from one more forward of ``images``, moved to ``to``."""
    from dis_yolo_tpu_torch.models import api
    got = {}
    hooks = [getattr(model, f"convolutional{i}").register_forward_hook(
        lambda mod, inp, out, i=i: got.__setitem__(i, out.detach().to(to)))
        for i in layers]
    try:
        raws = api.forward(model, images, device)
    finally:
        for h in hooks:
            h.remove()
    return got, tuple(r.to(to) for r in raws)


def paste_and_k1_bounds(pool, pasted, cfg) -> Dict[str, float]:
    """The paste's and K1's least times on the traced batches' boxes, as
    ``drivers/serve.py`` counts them for ``paste_roofline.serve`` and
    ``k1_roofline.serve``."""
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
    return {"paste_bound_s": work.roofline_s(nbytes, ops)[0],
            "k1_bound_s_per_call": sum(
                work.roofline_s(*work.k1_work(dets_h[..., :4].numpy(),
                                              cfg.mask_size, cfg.k_map))[0]
                for _, dets_h in pasted) / len(pasted)}


def run(ctx: harness.Context, graph: str = "default") -> harness.Outcome:
    clock, traffic, dev = ctx.clock, ctx.traffic, ctx.device
    cuda = torch.device(dev).type == "cuda"
    plain_float32()
    cfg = _cfg(ctx.config)
    if not cfg.quant:
        raise ValueError("serve_int8 serves a configuration with quant")
    from dis_yolo_tpu_torch.models import api  # noqa: F401
    from dis_yolo_tpu_torch.ops import _build
    clock.mark("import_port")
    if cuda:
        _build.load("assembly")
    clock.mark("kernels")
    pool = serve.Pool(traffic, cfg.image_size, ctx.seed, dev)
    clock.mark("pool")
    specs = serve._specs(cfg)
    calib = pool.images[pool.order[0]].to(dev)
    weights = make_weights(specs, ctx.seed, dev, calib)
    clock.mark("weights")

    # the reference's own calibration, then the program
    quant_layers = tuple(cfg.quant_layers)
    ref_absmax = ref_quant.calibrate(specs, weights, calib, quant_layers)
    model, absmax = build_model(cfg, weights, graph, calib, dev)
    held = held_scales(model)
    del calib
    clock.mark("model")

    # the threshold from the int8 reference's forward of the whole pool,
    # at the program's calibration and from the program's stem
    stem = ref_quant.stem_layers(specs, quant_layers)
    ref = ref_quant.Int8Net(specs, weights, absmax, quant_layers)
    heads = []
    for b in range(len(pool.images)):
        x = pool.images[b].to(dev)
        forced, _ = stem_outputs(model, x, stem, dev, dev)
        heads.append(ref(x, forced)[:3])
        del forced
    threshold = serve.calibrate([torch.cat([h[i] for h in heads])
                                 for i in range(3)] + [None],
                                torch.cat(pool.windows), cfg,
                                traffic["min_survivors"])
    del heads, ref
    weights = {k: v.cpu() for k, v in weights.items()}
    n_sizes = len(traffic["sizes"])
    server = serve.Server(cfg, model, pool, threshold, dev)
    clock.mark("threshold")
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

    # ---- the window, as drivers/serve.py's
    setup_s = clock.total()
    lat: List[float] = []
    kept: Dict[tuple, dict] = {}
    attempted = failed = images = kept_rows = 0
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
        except RuntimeError as exc:
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
    peak = kept_bytes = 0
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        kept_bytes = torch.cuda.memory_allocated()
        kept = {hw: serve._to(out, "cpu") for hw, out in kept.items()}
        kept_bytes -= torch.cuda.memory_allocated()
    int8_ops, other_ops = work_int8.forward_ops(specs, cfg.image_size,
                                                cfg.mask_stride, quant_layers)
    e2e = {"serve_img_per_s": images / window_s,
           "serve_batch_p95_ms": (float(np.percentile(lat, 95)) * 1e3
                                  if lat else math.inf),
           "peak_mem_gib": (peak - kept_bytes) / 2 ** 30,
           "setup_s": setup_s}
    counters = {"batches": float(len(lat)), "images_per_batch":
                float(traffic["batch"]), "rate_img_per_s": images / window_s,
                "flops_per_image": int8_ops + other_ops,
                "int8_ops_per_image": int8_ops,
                "ideal_s_per_image": work_int8.ideal_s(int8_ops, other_ops),
                "threshold": threshold, "kept_bytes": float(kept_bytes),
                "batch_p50_ms": (float(np.percentile(lat, 50)) * 1e3
                                 if lat else math.inf),
                "detections_per_image": kept_rows / max(images, 1)}

    # ---- the traced sub-window, the sync count and the program's window
    traces: list = []
    if ctx.trace and cuda:
        n, n_sync = traffic["profile_batches"], traffic["sync_batches"]
        pasted = []
        with tracing.profiled(n, traces):
            for p in range(i, i + n):
                b = pool.at(p)
                out = server.batch(b)
                pasted.append((b, out["dets_h"]))
                del out
        counters["syncs_per_batch"] = serve.count_syncs(
            server, range(i + n, i + n + n_sync))
        counters.update(paste_and_k1_bounds(pool, pasted, cfg))
        counters["program"] = program_trace.program_window(
            server, i + n + n_sync, n, n_sync, serve.count_syncs)

    gc.unfreeze()
    torch.set_num_threads(threads)

    # ---- the stem's outputs of each kept batch, from one more forward
    stems = {hw: stem_outputs(model, pool.images[out["batch"]].to(dev), stem,
                              dev) for hw, out in kept.items()}

    # ---- correctness, with the program freed
    del server, model
    if cuda:
        torch.cuda.empty_cache()
    weights = {k: v.to(dev) for k, v in weights.items()}
    ref = ref_quant.Int8Net(specs, weights, absmax, quant_layers)
    f32 = ref_net.Net(specs, weights)
    checks_by_name: Dict[str, float] = {
        "scale_err": ref_quant.scale_gap(held, ref_absmax)}
    for hw in list(kept):
        b = kept[hw].pop("batch")
        x = pool.images[b].to(dev)
        forced, again = stems.pop(hw)
        out = kept.pop(hw)
        got = {"rerun_diff": sum(serve._differ(a, r) for a, r in
                                 zip(again, out["raws"]))}
        ref_raws = ref(x, {i: t.to(dev) for i, t in forced.items()})
        got["stem_err"] = max(ref.forced_err.values(), default=0.0)
        got["raw_err_free"] = quad_rel(out["raws"], ref(x))[0]
        got.update(judge(serve._to(out, dev), ref_raws, f32(x),
                         pool.windows[b], cfg, threshold, hw))
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

"""Stage-2 fine-tuning from a corpus on the card: one process, a closed
loop of K-step blocks.

Set-up draws a corpus of inspection photos from the seed
(``photos.make_photos``, 1-4 polygon defects each, classes drawn from
the three), decodes and rasterizes it with the port's census
(``device_corpus.build_host_corpus``) and sends it to the card once
(``upload_corpus``).  The traffic's ``knobs`` are applied to the
configuration: every layer trains, Adam at the shipped schedule, flips
and photometric augmentation on the card, K steps a block.  As the
port's Solver does with its corpus, the host makes the placement
decisions on the loader's prefetch thread (``CorpusTrainData``) and
hands them over with ``utils.runtime.device_prefetch``; the ROI
generator is a CPU generator seeded ``seed + 1``, the augmentation's one
on the card seeded ``seed + 2``.  The Solver's file I/O, validation and
checkpoints are left out.

The weights are ``weights.make_weights``'s, the three YOLO heads'
kernels then scaled by the traffic's ``head_scale``: as drawn for
serving, the heads' raw logits reach 50 in the first block, and on 3 of
6 seeds Adam's early updates carried some xy logit below -88.7 within a
run, where the decode's literal sigmoid ``1 / (1 + exp(-x))`` overflows
and its gradient is NaN, so the step is skipped as non-finite.  Scaled
by 0.25 they stay within 20 over a whole run.

The timed path, one block, each a ``record_function`` span:

  decisions  the next block's decisions, on the card
  block      ``train_step.make_corpus_multi_step``: K steps, each
             assembling its batch on the card, augmenting it, the
             train-mode forward, the losses, the backward and Adam
  fetch      the block's stacked metrics to the host, as the Solver's
             summary row fetches them

Correctness, on the first block, which set-up drives through that same
call and feed before the window (the Trainer object then goes on into
the window).  The driver keeps the block's starting state (weights,
BatchNorm statistics, both generators' states), its decisions, and,
through a forward pre-hook and a forward hook it registers on the
model, the images each step's forward received, its four raw outputs
and, at the second step, the norms of Adam's first moment and the
running statistics (the state after one step).  After the window, with
the program freed, the plain float32 reference (``reference/train.py``,
``reference/data.py``) follows the three steps from the same start:

  data_diff     the images the program's forward received against the
                reference's assembly and augmentation of the same rows,
                placements and draws: values that differ
  raw_err       the first step's train-mode raw outputs against the
                reference's forward of the same images from the same
                weights: the quadratic mean of the four relative L2
                errors
  raw_loss_err  each loss term the program returned (conf, class,
                coord, mask; L2 and the total at the first step, the
                total less L2 later) against the reference's terms of
                the program's own raw outputs: relative error, worst
                term and step
  grad_err      the first gradient, as Adam's first moment after one
                step holds it (``mu / (1 - b1)``), against the
                reference's: per leaf, the gap between the two norms
                over the larger of the reference leaf's norm and the
                median leaf's; the median leaf
  update_err    the parameters' change over the three steps, per leaf
                measured as ``grad_err``; the worst leaf.  Leaves whose
                first reference gradient is under a thousandth of the
                median leaf's (root mean square) are left out
  stats_err     the BatchNorm running statistics' change at the first
                step (the state the second step's forward finds),
                measured as ``update_err``

The later steps' raw outputs and each step's total loss against the
reference's own are reported under ``judged`` and not compared: Adam's
first updates are nearly the sign of each gradient element, so bfloat16's
rounding of small gradients moves the two sides' weights apart, and the
loss, a sum over some 20,000 anchors an image, reads alike for the port
and for its float8 control.  The gradient is judged by its median leaf:
the first layers' weight gradients, small differences of large sums
through train-mode BatchNorm, read up to 0.9 apart in bfloat16 on sound
runs and agree to 5e-5 with the port's own float32 path.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from port_bench import harness, photos, trace as tracing, train_work
from port_bench.drivers import serve
from port_bench.reference import data as ref_data
from port_bench.reference import net as ref_net
from port_bench.reference import plain_float32
from port_bench.reference import train as ref_train
from port_bench.weights import HEADS, make_weights, program_state_dict

HP_KEYS = ("obj_threshold", "iou_threshold", "max_detection",
           "pre_nms_top_k", "k_map", "mask_scale", "l2_scale",
           "ignore_thresh", "object_scale", "noobject_scale", "class_scale",
           "coord_scale")


def _cfg(config: dict, traffic: dict):
    knobs = dict(traffic["knobs"])
    knobs["locked_layers"] = tuple(knobs["locked_layers"])
    return serve._cfg(config).replace(**knobs)


def make_corpus(cfg, traffic: dict, seed: int, device):
    """(labels, host corpus, a few letterboxed photos for the BatchNorm
    statistics of the weights) of the traffic's seeded photos."""
    from dis_yolo_tpu_torch.data import device_corpus
    sizes = [tuple(s) for s in traffic["sizes"]]
    made = photos.make_photos(seed, sizes, traffic["pool"] // len(sizes),
                              traffic["max_defects"], device)
    pictures, labels, calib = {}, [], []
    for hw in sizes:
        calib.append(photos.letterbox(made[hw]["photos"][:4],
                                      cfg.image_size)[0])
        for i, (pic, polys) in enumerate(zip(made[hw]["photos"].cpu().numpy(),
                                             made[hw]["polygons"])):
            name = f"{hw[0]}x{hw[1]}/{i}"
            pictures[name] = pic
            labels.append({
                "imname": name,
                "class_names": [cfg.classes[c] for c, _ in polys],
                "polygons": [[{"type": "out",
                               "all_points_x": p[:, 0].tolist(),
                               "all_points_y": p[:, 1].tolist()}]
                             for _, p in polys]})
    host = device_corpus.build_host_corpus(cfg, labels=labels,
                                           load_image=pictures.__getitem__)
    return labels, host, torch.cat(calib)


class Trainer:
    """The port's training path over one corpus: the system under
    test."""

    def __init__(self, cfg, model, host, labels, seed: int, device):
        from dis_yolo_tpu_torch.data import device_corpus
        from dis_yolo_tpu_torch.train import train_step
        from dis_yolo_tpu_torch.utils.runtime import device_prefetch
        self.cfg, self.k = cfg, cfg.steps_per_dispatch
        self.corpus = device_corpus.upload_corpus(host, device)
        self.state = train_step.init_train_state(model, device)
        self.multi = train_step.make_corpus_multi_step(model, device)
        self.rng = torch.Generator().manual_seed(seed + 1)
        self.aug_rng = torch.Generator(device=device).manual_seed(seed + 2)
        self.data = device_corpus.CorpusTrainData(
            cfg, seed=int(np.random.default_rng([seed, 4]).integers(2 ** 31)),
            labels=labels, corpus=host)
        self.data.start_prefetch()
        self.blocks = device_prefetch(self._decisions(), size=2,
                                      device=device)

    def _decisions(self):
        while True:
            steps = [self.data.next_prefetched() for _ in range(self.k)]
            yield {key: np.stack([s[key] for s in steps]) for key in steps[0]}

    def block(self):
        """One block: (its decisions on the card, its metrics on the
        host)."""
        from torch.profiler import record_function
        with record_function("decisions"):
            decisions = next(self.blocks)
        with record_function("block"):
            self.state, metrics = self.multi(self.state, self.corpus,
                                             decisions, self.rng,
                                             self.aug_rng)
        with record_function("fetch"):
            rows = {k: v.cpu() for k, v in metrics.items()}
        return decisions, rows


class Recorder:
    """The forward pre-hook and forward hook the driver registers on the
    model for the judged block: each step's input images and raw
    outputs, and at the second step the norms of Adam's first moment and
    the running statistics (the state after one step)."""

    def __init__(self, model, trainer: Trainer):
        self.trainer = trainer
        self.images: List[torch.Tensor] = []
        self.raws: List[tuple] = []
        self.mu_names: List[str] = []
        self.mu_norms = None
        self.stats_1 = None
        self.handles = [model.register_forward_pre_hook(self._pre),
                        model.register_forward_hook(self._post)]

    def _pre(self, module, args):
        if len(self.images) == 1:
            mu = self.trainer.state.opt.mu
            self.mu_names = list(mu)
            self.mu_norms = torch.stack(torch._foreach_norm(
                [mu[n].float() for n in self.mu_names]))
            self.stats_1 = {k: v.clone() for k, v in module.state_dict().items()
                            if k.endswith(("running_mean", "running_var"))}
        self.images.append(args[0].detach())

    def _post(self, module, args, out):
        self.raws.append(tuple(o.detach() for o in out))

    def remove(self):
        for h in self.handles:
            h.remove()


def _host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    return obj


def _rel(got: float, want: float) -> float:
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-30)


def gaps(got: Dict[str, float], want: Dict[str, float], names
         ) -> Dict[str, float]:
    """Per leaf, the gap of norms ``|got - want|`` over the larger of
    ``want`` and the median of ``want`` over ``names``; a non-finite
    norm reads as an infinite gap."""
    med = statistics.median(want[n] for n in names)
    out = {}
    for n in names:
        gap = abs(got[n] - want[n]) / max(want[n], med, 1e-30)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def worst(by_leaf: Dict[str, float]) -> tuple:
    """(the worst leaf's gap, the five worst leaves and their gaps)."""
    order = sorted(by_leaf, key=by_leaf.get, reverse=True)
    return by_leaf[order[0]], [[n, by_leaf[n]] for n in order[:5]]


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def judge(kept: dict, specs, hp: dict, cfg_dict: dict, device
          ) -> Dict[str, float]:
    """The checks of the judged block (the module docstring), and what
    they were read from."""
    dev = torch.device(device)
    start = kept["start"]
    ref = ref_train.Trainer(specs, {k: v.to(dev) for k, v in start.items()},
                            hp)
    aug = torch.Generator(device=dev)
    aug.set_state(kept["aug_state"])
    roi = torch.Generator()
    roi.set_state(kept["roi_state"])
    b, size = cfg_dict["batch_size"], cfg_dict["image_size"]
    data_diff = 0
    raw_errs, loss_errs, raw_loss_errs, per_output = [], [], [], []
    first_grad = stats_1 = None
    for t in range(len(kept["images"])):
        dec = {k: v[t].numpy() for k, v in kept["decisions"].items()}
        draws = ref_data.draw_augment(aug, b, size)
        u_prop, u_gt = (u.to(dev) for u in ref_data.draw_uniforms(
            roi, b, hp["max_detection"], cfg_dict["max_box_per_image"]))
        batch = ref_data.augment(ref_data.assemble(kept["corpus"], dec,
                                                   cfg_dict, dev),
                                 draws, size)
        data_diff += serve._differ(kept["images"][t], batch["images"])
        raws = tuple(r.to(dev) for r in kept["raws"][t])
        terms = {k: float(v[t]) for k, v in kept["metrics"].items()}
        try:
            dets = ref_train.proposals(raws, hp)
            with torch.no_grad():
                of_raws = ref_train.losses(raws, batch, dets, u_prop, u_gt,
                                           ref.params, hp)
            raw_loss_errs.append(raw_loss_gap(terms, of_raws, t))
        except RuntimeError as exc:         # the program's shapes are off
            print(f"port_bench: the loss of the program's raw outputs "
                  f"failed: {exc}")
            raw_loss_errs.append(math.inf)
            dets = ref_train.proposals(
                ref_train.TrainNet(specs, {**ref.params, **ref.stats})(
                    batch["images"]), hp)
        out = ref.step(batch, dets, u_prop, u_gt)
        errs = [serve._rel_l2(p.float(), r) for p, r in zip(raws, out["raws"])]
        per_output.append(errs)
        raw_errs.append(math.sqrt(sum(e * e for e in errs) / len(errs)))
        loss_errs.append(_rel(terms["total_loss"],
                              float(out["terms"]["total_loss"])))
        if t == 0:
            first_grad = out["grads"]
            stats_1 = {k: v.clone() for k, v in ref.stats.items()}
        del batch, raws, out
    names = list(first_grad)
    g_ref = _norms(first_grad)
    got = dict(zip(kept["mu_names"],
                   (kept["mu_norms"].double()
                    / (1.0 - ref_train.ADAM_B1)).tolist())) \
        if kept["mu_norms"] is not None else {}
    grad_by_leaf = gaps({n: got.get(n, 0.0) for n in names}, g_ref, names)
    rms = {n: g_ref[n] / math.sqrt(first_grad[n].numel()) for n in names}
    floor = 1e-3 * statistics.median(rms.values())
    moved = [n for n in names if rms[n] >= floor]
    after = kept["after"]

    def change(state, names):
        return _norms({n: state[n].to(dev) - start[n].to(dev)
                       for n in names})

    update_by_leaf = gaps(change(after, moved), change(ref.params, moved),
                          moved)
    stat_names = list(ref.stats)
    stats_by_leaf = gaps(change(after, stat_names),
                         change(ref.stats, stat_names), stat_names)
    stats1_by_leaf = gaps(change(kept["stats_1"], stat_names)
                          if kept["stats_1"] is not None
                          else dict.fromkeys(stat_names, 0.0),
                          change(stats_1, stat_names), stat_names)
    grad_worst, grad_top = worst(grad_by_leaf)
    update_err, update_top = worst(update_by_leaf)
    stats_err, stats_top = worst(stats1_by_leaf)
    stats3_err, stats3_top = worst(stats_by_leaf)
    return {"data_diff": data_diff, "raw_err": raw_errs[0],
            "raw_loss_err": max(raw_loss_errs),
            "grad_err": statistics.median(grad_by_leaf.values()),
            "update_err": update_err, "stats_err": stats_err,
            "judged": {"grad_worst": grad_worst, "grad_top": grad_top,
                       "grad_quartiles": statistics.quantiles(
                           grad_by_leaf.values(), n=4),
                       "update_top": update_top,
                       "update_median": statistics.median(
                           update_by_leaf.values()),
                       "stats_top": stats_top, "stats3_err": stats3_err,
                       "stats3_top": stats3_top,
                       "leaves_left_out": len(names) - len(moved),
                       "raw_err_by_step": raw_errs,
                       "raw_err_by_output": per_output,
                       "loss_err_by_step": loss_errs,
                       "raw_loss_err_by_step": raw_loss_errs}}


def raw_loss_gap(prog: Dict[str, float], ref: Dict[str, torch.Tensor],
                 step: int) -> float:
    """The worst relative error of the program's loss terms against the
    reference's terms of the program's raw outputs.  L2 and the total
    are compared at the first step, where both sides hold the same
    weights; later, each side's L2 is of its own weights, which Adam's
    first, nearly sign-like updates have moved apart, so the total less
    L2 is compared."""
    want = {k: float(v) for k, v in ref.items()}
    keys = ["conf_loss", "class_loss", "coord_loss", "mask_loss"]
    if step == 0:
        keys += ["l2_loss", "total_loss"]
    else:
        prog = {**prog, "total_less_l2": prog["total_loss"] - prog["l2_loss"]}
        want["total_less_l2"] = want["total_loss"] - want["l2_loss"]
        keys.append("total_less_l2")
    return max(_rel(prog[k], want[k]) for k in keys)


def count_syncs(trainer: Trainer, blocks: int) -> float:
    """Host syncs per step, counted by PyTorch's sync debug mode."""
    n = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(blocks):
                trainer.block()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            n += 1
    return n / max(blocks * trainer.k, 1)


def run(ctx: harness.Context, graph: str = "default") -> harness.Outcome:
    from port_bench import train_control
    clock, traffic, dev = ctx.clock, ctx.traffic, ctx.device
    cuda = torch.device(dev).type == "cuda"
    plain_float32()
    cfg = _cfg(ctx.config, traffic)
    if graph == "float32":      # the port's own float32 path, a witness
        cfg, graph = cfg.replace(compute_dtype="float32"), "default"
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.ops import _build
    clock.mark("import_port")
    if cuda:
        _build.load("assembly")
        _build.load("assembly_bwd")
    clock.mark("kernels")
    labels, host, calib = make_corpus(cfg, traffic, ctx.seed, dev)
    clock.mark("corpus")
    specs = ref_net.layer_specs(cfg.image_size, cfg.mask_stride,
                                cfg.num_class, cfg.k_map,
                                cfg.anchors_per_scale)
    weights = make_weights(specs, ctx.seed, dev, calib.to(dev))
    del calib
    for idx in HEADS:
        weights[f"convolutional{idx}.conv.weight"] *= traffic["head_scale"]
    model = api.create_model(cfg, dev)
    model.load_state_dict(program_state_dict(weights))
    del weights
    undo = train_control.plant(graph, model)
    trainer = Trainer(cfg, model, host, labels, ctx.seed, dev)
    clock.mark("model")

    # ---- the judged block: the first, through the window's own call
    kept = {"start": _host({k: v for k, v in model.state_dict().items()
                            if not k.endswith("num_batches_tracked")}),
            "roi_state": trainer.rng.get_state(),
            "aug_state": trainer.aug_rng.get_state()}
    rec = Recorder(model, trainer)
    decisions, rows = trainer.block()
    rec.remove()
    kept.update(decisions=_host(decisions), metrics=rows,
                images=_host(rec.images), raws=_host(rec.raws),
                mu_names=rec.mu_names, mu_norms=_host(rec.mu_norms),
                stats_1=_host(rec.stats_1),
                after=_host({k: v for k, v in model.state_dict().items()}),
                corpus={"images": host.images,
                        "masks_packed": host.masks_packed,
                        "sizes": host.sizes})
    set_up_notfinite = trainer.state.opt.total_notfinite
    del rec, decisions
    clock.mark("judged_block")
    for _ in range(traffic["warmup_blocks"]):
        trainer.block()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    clock.mark("warmup")

    # ---- the window
    setup_s = clock.total()
    k, b = trainer.k, cfg.batch_size
    attempted = failed = blocks = 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()
    notfinite = trainer.state.opt.total_notfinite
    t_start = time.perf_counter()
    block_s: List[float] = []
    while True:
        attempted += k
        t0 = time.perf_counter()
        try:
            trainer.block()
        except RuntimeError as exc:      # a failed block counts, and ends
            failed += k
            print(f"port_bench: block {blocks} failed: {exc}")
            break
        t1 = time.perf_counter()
        block_s.append(t1 - t0)
        blocks += 1
        if t1 - t_start >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_start
    failed += trainer.state.opt.total_notfinite - notfinite
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rate = blocks * k * b / window_s
    e2e = {"train_img_per_s": rate, "peak_mem_gib": peak / 2 ** 30,
           "setup_s": setup_s}
    counters = {"blocks": float(blocks), "steps_per_block": float(k),
                "images_per_step": float(b), "rate_img_per_s": rate,
                "flops_per_image": train_work.train_flops(
                    specs, cfg.image_size, cfg.mask_stride),
                "block_p50_ms": (float(np.percentile(block_s, 50)) * 1e3
                                 if block_s else math.inf),
                "set_up_notfinite": float(set_up_notfinite)}

    # ---- the traced sub-window and the sync count, after the window
    traces: list = []
    if ctx.trace and cuda:
        n = traffic["profile_blocks"]
        with tracing.profiled(n * k, traces):
            for _ in range(n):
                trainer.block()
        counters["syncs_per_step"] = count_syncs(trainer,
                                                 traffic["sync_blocks"])
    gc.unfreeze()
    torch.set_num_threads(threads)
    trainer.data.stop()
    undo()

    # ---- correctness, with the program freed
    del trainer, model
    if cuda:
        torch.cuda.empty_cache()
    hp = {key: getattr(cfg, key) for key in HP_KEYS}
    hp.update(anchors=np.asarray(cfg.anchors_array(), np.float32).tolist(),
              lr_boundaries=tuple(cfg.lr_boundaries),
              lr_values=tuple(cfg.lr_values))
    cfg_dict = {"image_size": cfg.image_size, "batch_size": b,
                "max_box_per_image": cfg.max_box_per_image,
                "anchors": hp["anchors"], "base_grid": cfg.base_grid,
                "anchors_per_scale": cfg.anchors_per_scale,
                "classes": list(cfg.classes)}
    got = judge(kept, specs, hp, cfg_dict, dev)
    counters["judged"] = got.pop("judged")
    checks = [(name, got.get(name, math.inf), ctx.limits[name])
              for name in ctx.limits]
    return harness.Outcome(e2e=e2e, attempted=attempted, failed=failed,
                           memory_peak_bytes=int(peak), checks=checks,
                           counters=counters,
                           trace=traces[0] if traces else None)

"""Command-line interface of the port (the counterpart of
``dis_yolo_tpu/cli.py``):

    python -m dis_yolo_tpu_torch.cli {train,eval,preprocess,synth,
                                      convert-tf1,convert-darknet} ...

    python -m dis_yolo_tpu_torch.cli {infer,export,verify-gt} ...

The subcommands take the JAX CLI's flags, plus ``--device`` (default
``cuda``; ``--device cpu`` runs the plain PyTorch path on the CPU, and
without a card nothing falls back to it); ``export`` takes ``--device``
in place of ``--platforms``.  ``train --device-corpus`` implies the
device-side augs, as in the JAX CLI.

``train --data-parallel`` and ``eval --data-parallel`` run one process
per rank under ``torch.distributed.run``:

    python -m torch.distributed.run --nproc-per-node N \
        -m dis_yolo_tpu_torch.cli train --data-parallel ...

Each rank joins the process group (``parallel.distributed.initialize``:
NCCL with a card per rank, gloo on the CPU or when ranks share a card)
and works on its card (``LOCAL_RANK``); ``--batch-size`` is the global
batch.  Without torchrun it is one rank.  Rank 0 alone writes the logs,
the checkpoints and ``eval``'s result line.
``preprocess`` and ``synth`` need OpenCV.

``infer`` and ``verify-gt`` write their overlays as ``<stem>.png``
(``data.image_io.write_png``: the card's machine has neither OpenCV nor
PIL), where the JAX CLI keeps the input's name; without PIL the labels
are left off and a note says so on stderr.  ``infer --artifact`` serves
a dynamic-batch artifact at B=1 (the JAX CLI reads its batch as an int
and fails on it).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def _add_common(p):
    p.add_argument("--dataset", default="data", help="dataset root directory")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--image-size", type=int, default=576)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mask-stride", type=int, default=2, choices=[1, 2, 4],
                   help="mask-decoder output stride (reference variants)")
    p.add_argument("--k-map", type=int, default=3,
                   help="k for the k^2 position-sensitive score maps")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent fallback")


def _make_cfg(args, **overrides):
    from dis_yolo_tpu_torch.config import DISYoloConfig
    kw = dict(dataset=args.dataset, output_dir=args.output_dir,
              image_size=args.image_size, test_size=args.image_size,
              batch_size=args.batch_size,
              mask_stride=getattr(args, "mask_stride", 2),
              k_map=getattr(args, "k_map", 3))
    kw.update(overrides)
    return DISYoloConfig(**kw)


def cmd_preprocess(args):
    from dis_yolo_tpu_torch.data.preprocess import build_ground_truth_cache
    annos = build_ground_truth_cache(args.dataset, args.phase, force=args.force)
    print(f"{args.phase}: {len(annos)} annotated images cached")


def cmd_synth(args):
    from dis_yolo_tpu_torch.data.preprocess import build_ground_truth_cache
    from dis_yolo_tpu_torch.data.synthetic import generate_dataset
    generate_dataset(args.dataset, images_per_phase=args.images,
                     image_size=args.size, seed=args.seed)
    for phase in ("train", "val", "test"):
        build_ground_truth_cache(args.dataset, phase)
    print(f"synthetic dataset at {args.dataset}")


@contextlib.contextmanager
def _mesh(args, cfg):
    """The data-parallel mesh of ``--data-parallel`` (None without it),
    the process group left at the end."""
    if not args.data_parallel:
        yield None
        return
    from dis_yolo_tpu_torch.parallel import distributed
    from dis_yolo_tpu_torch.parallel.sharding import make_mesh
    distributed.initialize(args.device)
    try:
        yield make_mesh(args.device, axis_name=cfg.dp_axis)
    finally:
        distributed.shutdown()


def cmd_train(args):
    """Returns the Solver after training (for callers in process)."""
    from dis_yolo_tpu_torch.data.val_data import DefectValData
    from dis_yolo_tpu_torch.eval.map_eval import Evaluator
    from dis_yolo_tpu_torch.train.solver import Solver

    locked = tuple(range(1, 53)) if args.stage == 1 else ()
    extra = {}
    if args.device_corpus:
        # the pixels live on the device: the augs run there too
        extra.update(device_corpus=True, device_side_augs=True)
    cfg = _make_cfg(args, locked_layers=locked, max_iter=args.max_iter,
                    save_iter=args.save_iter, summary_iter=args.summary_iter,
                    steps_per_dispatch=args.steps_per_dispatch, **extra)
    with _mesh(args, cfg) as mesh:
        evaluator = val = None
        if not args.no_validation:
            evaluator = Evaluator(cfg, "val")
            val = DefectValData(cfg, "val")
        solver = Solver(cfg, evaluator=evaluator, val_data=val, mesh=mesh,
                        seed=args.seed, restore=args.restore,
                        weights_from=args.weights_from,
                        tf1_weights=args.tf1_weights, device=args.device)
        solver.train()
    return solver


def cmd_eval(args):
    cfg = _make_cfg(args)
    with _mesh(args, cfg) as mesh:
        _evaluate(args, cfg, mesh)


def _evaluate(args, cfg, mesh):
    """``eval`` on this rank: each rank sweeps its share with a mesh."""
    from dis_yolo_tpu_torch.data.val_data import DefectValData
    from dis_yolo_tpu_torch.eval.map_eval import Evaluator
    from dis_yolo_tpu_torch.eval.sweep import run_split
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.train import checkpoint as ckpt

    device = args.device if mesh is None else mesh.device
    model = api.init_model(cfg, 0, device=device)
    if args.checkpoint:
        ckpt.restore_weights(args.checkpoint, model)
    evaluator = Evaluator(cfg, args.phase, with_semantic=True)
    images, names, windows = DefectValData(cfg, args.phase).get()
    if args.quant:
        # the int8 serving graph, calibrated on train-split images (on the
        # eval split, with a note, when there is no train split)
        from dis_yolo_tpu_torch.models.fold import deploy_variables
        from dis_yolo_tpu_torch.models.quant import (calibrate_deploy,
                                                     quantize_deploy)
        n_calib = args.quant_calib_images
        try:
            calib = DefectValData(cfg, "train").get()[0][:n_calib]
        except (OSError, AssertionError):
            calib = images[:n_calib]
            print("note: no train split found - calibrating on eval images "
                  "(activation-range leakage only)")
        dv = deploy_variables(model.state_dict())
        cmodel = api.create_model(cfg.replace(quant=True, quant_calibrate=True),
                                  device=device)
        scales = calibrate_deploy(cmodel, dv, calib,
                                  use_pct=args.quant_calib == "pct")
        model = api.create_model(cfg.replace(quant=True), device=device)
        model.load_state_dict(quantize_deploy(dv, scales))
        print(f"int8 graph: {len(scales)} layers quantized "
              f"({args.quant_calib} scales, {len(calib)} calib images)")
    device_score = bool(args.device_score)
    detdata, t_pred = run_split(
        cfg, model, images, names, windows,
        device_paste=bool(args.device_paste), gt_sizes=evaluator.gt_sizes,
        want_semantic=True, device_score=device_score,
        gt_records=evaluator.gt_masks,
        gt_semantic=evaluator.gt_semantic if device_score else None,
        mesh=mesh, device=device)
    if not ckpt.is_primary():
        return
    if device_score:
        res = evaluator.evaluate_detections(detdata)
        miou = evaluator.miou_from_confusions(
            {d["imname"]: d["confusion"] for d in detdata})
    else:
        res = evaluator.evaluate_detections(detdata, collect_semantic=True)
        miou = evaluator.miou(res.pop("semantic_maps"))
    n_timed = max(len(names), 1)
    t_post = res.pop("t_post_s")
    print(json.dumps({"AP": res["AP"], "mAP": res["mAP"],
                      "recall": res["recall"], "precision": res["precision"],
                      "iou": miou["iou"], "miou": miou["miou"],
                      "s_per_image": (t_pred + t_post) / n_timed,
                      "s_per_image_device": t_pred / n_timed,
                      "s_per_image_post": t_post / n_timed}))


def _labels_note():
    from dis_yolo_tpu_torch.utils.visualize import have_labels
    if not have_labels():
        print("note: PIL is not installed: the overlays carry no labels",
              file=sys.stderr)


def cmd_verify_gt(args):
    from dis_yolo_tpu_torch.utils.visualize import render_groundtruth
    _labels_note()
    paths = render_groundtruth(args.dataset, args.phase, limit=args.limit)
    print(f"wrote {len(paths)} verification overlays")


def _read(path):
    from dis_yolo_tpu_torch.data.image_io import read_image
    try:
        return read_image(path)
    except (OSError, RuntimeError, ValueError) as e:
        raise SystemExit(f"error: cannot read image {path!r} ({e})")


def _serving_model(cfg, args, calib_images=None, folded=False):
    """The serving graph of ``--checkpoint`` (seed-0 weights without
    one): the int8 graph calibrated on ``calib_images`` with ``--quant``,
    else the BN-folded graph (``folded``: ``fold_batchnorm``, the same
    layers) or the deploy graph.  Returns (serving config, model)."""
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.models.fold import (deploy_variables,
                                                fold_batchnorm)
    from dis_yolo_tpu_torch.train import checkpoint as ckpt

    model = api.init_model(cfg, 0, device=args.device)
    if args.checkpoint:
        ckpt.restore_weights(args.checkpoint, model)
    if folded and not args.quant:
        model.load_state_dict(fold_batchnorm(model.state_dict()))
        return cfg, model
    dv = deploy_variables(model.state_dict())
    del model
    if args.quant:
        from dis_yolo_tpu_torch.models.quant import (calibrate_deploy,
                                                     quantize_deploy)
        cmodel = api.create_model(cfg.replace(quant=True, quant_calibrate=True),
                                  device=args.device)
        scales = calibrate_deploy(cmodel, dv, calib_images,
                                  use_pct=args.quant_calib == "pct")
        del cmodel
        serve_cfg = cfg.replace(quant=True)
        state = quantize_deploy(dv, scales)
        print(f"int8 graph: {len(scales)} layers quantized "
              f"({args.quant_calib} scales, {len(calib_images)} calib "
              "images)")
    else:
        serve_cfg, state = cfg.replace(deploy=True), dv
    model = api.create_model(serve_cfg, device=args.device)
    model.load_state_dict(state)
    return serve_cfg, model


def cmd_infer(args):
    """Single-image / directory inference with overlay output: the
    BN-folded graph of ``--checkpoint``, the int8 graph (``--quant``,
    calibrated on the first 8 inputs) or an exported artifact."""
    import numpy as np
    import torch
    from dis_yolo_tpu_torch.data.image_io import write_png
    from dis_yolo_tpu_torch.data.val_data import letterbox_image
    from dis_yolo_tpu_torch.eval.postprocess import detections_to_original
    from dis_yolo_tpu_torch.utils.visualize import draw_instances

    cfg = _make_cfg(args, batch_size=1)
    paths = ([os.path.join(args.images, f)
              for f in sorted(os.listdir(args.images))
              if f.lower().endswith((".jpg", ".png", ".jpeg"))]
             if os.path.isdir(args.images) else [args.images])
    _labels_note()

    if args.artifact:
        # serve from an exported artifact: no model code, no checkpoint,
        # the weights are inside (export.py)
        from dis_yolo_tpu_torch.export import load_artifact
        run_art, meta = load_artifact(args.artifact)
        art_cfg = meta.get("config", {})
        size = int(art_cfg.get("test_size", cfg.test_size))
        batch = meta.get("in_shapes", [[1]])[0][0]
        # a dynamic batch (its name) is served at B=1
        bsz = batch if isinstance(batch, int) else 1
        classes = tuple(art_cfg.get("classes", cfg.classes))
        dev = torch.device(meta.get("device", args.device))

        def predict(canvas, window):
            imgs = np.zeros((bsz, size, size, 3), np.float32)
            imgs[0] = canvas
            wins = np.tile(np.asarray(window, np.float32), (bsz, 1))
            return run_art(torch.from_numpy(imgs).to(dev),
                           torch.from_numpy(wins).to(dev))
    else:
        from dis_yolo_tpu_torch.models import api
        size, classes = cfg.test_size, cfg.classes
        calib = None
        if args.quant:
            # no train split here: the activation scales calibrate on the
            # first inputs themselves, the deployment's own distribution
            calib = np.stack([letterbox_image(_read(p), size)[0]
                              for p in paths[:8]])
        _, model = _serving_model(cfg, args, calib, folded=True)

        def predict(canvas, window):
            return api.predict(model, canvas[None], window[None],
                               args.threshold, device=args.device)

    os.makedirs(args.out, exist_ok=True)
    for path in paths:
        t0 = time.perf_counter()
        rgb = _read(path)
        h, w = rgb.shape[:2]
        canvas, window = letterbox_image(rgb, size)
        dets, masks = predict(canvas, window)
        insts = detections_to_original(dets[0].cpu().numpy(),
                                       masks[0].cpu().numpy(), h, w, size)
        rendered = draw_instances(rgb, [
            {"classname": classes[i["classid"]], "mask": i["mask"],
             "box": i["box"], "score": i["score"]} for i in insts])
        stem = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.out, stem + ".png")
        write_png(out_path, rendered)
        # read, letterbox, predict, paste, render and write
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{path}: {len(insts)} detections -> {out_path} ({ms:.1f} ms)")


def cmd_export(args):
    """Write the serving graph (weights inside) as a self-contained
    ``torch.export`` artifact: the deploy graph, or the int8 graph with
    ``--quant`` (calibrated on the train split)."""
    from dis_yolo_tpu_torch import export as exp
    from dis_yolo_tpu_torch.data.val_data import DefectValData

    bs = args.symbolic_batch or args.batch_size
    cfg = _make_cfg(args, batch_size=bs if isinstance(bs, int) else 1)
    calib = None
    if args.quant:
        try:
            calib = DefectValData(cfg, "train").get()[0][
                :args.quant_calib_images]
        except (OSError, AssertionError):
            raise SystemExit("error: --quant export calibrates on the "
                             "train split; none found under --dataset")
    serve_cfg, model = _serving_model(cfg, args, calib)
    ep = exp.export_predict(serve_cfg, model, batch_size=bs,
                            obj_thresh=args.threshold, device=args.device)
    blob = exp.save_artifact(ep, args.out, serve_cfg,
                             obj_thresh=args.threshold,
                             extra_meta={"quant": bool(args.quant),
                                         "checkpoint": args.checkpoint})
    print(json.dumps({
        "artifact": blob, "meta": args.out + ".json",
        "device": str(args.device), "batch_size": bs,
        "image_size": cfg.test_size, "bytes": os.path.getsize(blob)}))


def cmd_convert_tf1(args):
    import numpy as np
    from dis_yolo_tpu_torch.train.checkpoint import convert_tf1_checkpoint
    values = convert_tf1_checkpoint(args.ckpt)
    np.save(args.out, values, allow_pickle=True)
    print(f"saved {len(values)} tensors to {args.out}")


def cmd_convert_darknet(args):
    import numpy as np
    import torch
    from dis_yolo_tpu_torch.config import DISYoloConfig
    from dis_yolo_tpu_torch.models.dis_yolo import DISYolo
    from dis_yolo_tpu_torch.train.checkpoint import read_darknet_weights
    cfg = DISYoloConfig(classes=tuple(f"class{i}"
                                      for i in range(args.num_class)))
    with torch.device("meta"):       # shapes only, no 62M-parameter init
        sd = DISYolo(cfg).state_dict()
    values = read_darknet_weights(args.weights, sd,
                                  source_classes=args.source_classes)
    np.save(args.out, values, allow_pickle=True)
    print(f"saved {len(values)} tensors to {args.out} "
          f"(feed to train --tf1-weights for the stage-1 restore)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dis_yolo_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("preprocess", help="build the GT cache for a split")
    _add_common(p)
    p.add_argument("--phase", default="train", choices=["train", "val", "test"])
    p.add_argument("--force", action="store_true")
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("synth", help="generate a synthetic demo dataset")
    _add_common(p)
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--size", type=int, default=320)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("train", help="train DIS-YOLO")
    _add_common(p)
    p.add_argument("--stage", type=int, default=1, choices=[1, 2],
                   help="1: heads only (backbone locked); 2: all layers")
    p.add_argument("--max-iter", type=int, default=10000)
    p.add_argument("--save-iter", type=int, default=500)
    p.add_argument("--summary-iter", type=int, default=50)
    p.add_argument("--restore", default=None,
                   help="checkpoint step directory to resume ('auto' = latest)")
    p.add_argument("--weights-from", default=None,
                   help="load weights only (stage-1 -> stage-2 bridge)")
    p.add_argument("--tf1-weights", default=None,
                   help="converted TF1 weights (.npy) for stage-1 restore")
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank of a data-parallel run under "
                        "torch.distributed.run (--batch-size is global)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="train steps per block (snapped to a divisor of "
                        "--save-iter)")
    p.add_argument("--device-corpus", action="store_true",
                   help="decoded split resident on the device; the host "
                        "ships placement decisions only (implies the "
                        "device-side augs)")
    p.add_argument("--no-validation", action="store_true")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="mask mAP@0.5 + mIoU on a split")
    _add_common(p)
    p.add_argument("--phase", default="test", choices=["val", "test"])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank of a data-parallel sweep under "
                        "torch.distributed.run (each rank sweeps its share)")
    p.add_argument("--quant", action="store_true",
                   help="serve the int8 post-training-quantized graph "
                        "(calibrated on train-split images)")
    p.add_argument("--quant-calib", default="pct", choices=["max", "pct"])
    p.add_argument("--quant-calib-images", type=int, default=8)
    p.add_argument("--device-paste", action="store_true",
                   help="paste masks to original resolution on the device")
    p.add_argument("--device-score", action="store_true",
                   help="score on the device: mask IoU matrices and mIoU "
                        "confusion totals")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("verify-gt", help="render GT verification overlays")
    _add_common(p)
    p.add_argument("--phase", default="train", choices=["train", "val", "test"])
    p.add_argument("--limit", type=int, default=None)
    p.set_defaults(fn=cmd_verify_gt)

    p = sub.add_parser("infer", help="run inference + overlay on image(s)")
    _add_common(p)
    p.add_argument("--images", required=True, help="image file or directory")
    p.add_argument("--out", default="infer_out")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--threshold", type=float, default=0.25)
    p.add_argument("--quant", action="store_true",
                   help="serve the int8 graph (activation scales "
                        "calibrated on the first input images)")
    p.add_argument("--quant-calib", default="pct", choices=["max", "pct"])
    p.add_argument("--artifact", default=None,
                   help="serve from an exported artifact (see the `export` "
                        "subcommand) on the device it was exported for; "
                        "ignores --checkpoint/--quant/--threshold")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("export", help="write the serving graph as a "
                                      "self-contained torch.export artifact")
    _add_common(p)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", required=True,
                   help="artifact path prefix (writes .pt2 + .json)")
    p.add_argument("--threshold", type=float, default=0.25)
    p.add_argument("--quant", action="store_true",
                   help="export the int8 graph (calibrated on the train "
                        "split)")
    p.add_argument("--quant-calib", default="pct", choices=["max", "pct"])
    p.add_argument("--quant-calib-images", type=int, default=8)
    p.add_argument("--symbolic-batch", nargs="?", const="b", default=None,
                   metavar="DIM",
                   help="export an artifact whose batch dim is dynamic "
                        "(serves any batch size); optional dim name, "
                        "default 'b'")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("convert-tf1", help="TF1 .ckpt -> .npy weight dict")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_convert_tf1)

    p = sub.add_parser(
        "convert-darknet",
        help="darknet yolov3.weights -> .npy weight dict (TF1 names)")
    p.add_argument("--weights", required=True, help="path to .weights binary")
    p.add_argument("--out", required=True)
    p.add_argument("--num-class", type=int, default=3)
    p.add_argument("--source-classes", type=int, default=80)
    p.set_defaults(fn=cmd_convert_darknet)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)

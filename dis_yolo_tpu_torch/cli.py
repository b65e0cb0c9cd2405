"""Command-line interface of the port (the counterpart of
``dis_yolo_tpu/cli.py``):

    python -m dis_yolo_tpu_torch.cli {train,eval,preprocess,synth,
                                      convert-tf1,convert-darknet} ...

The subcommands take the JAX CLI's flags, plus ``--device`` (default
``cuda``; ``--device cpu`` runs the plain PyTorch path on the CPU, and
without a card nothing falls back to it).  Not ported yet: ``infer``,
``export`` and ``verify-gt`` (they need the export path and the overlay
renderer) print so and exit 2; ``train --data-parallel``,
``--steps-per-dispatch > 1`` and ``--device-corpus`` exit with a "not
ported yet" error.  ``preprocess`` and ``synth`` need OpenCV.
"""

from __future__ import annotations

import argparse
import json
import sys

NOT_PORTED = ("infer", "export", "verify-gt")


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


def cmd_train(args):
    """Returns the Solver after training (for callers in process)."""
    from dis_yolo_tpu_torch.data.val_data import DefectValData
    from dis_yolo_tpu_torch.eval.map_eval import Evaluator
    from dis_yolo_tpu_torch.train.solver import Solver

    for flag, asked in (("--data-parallel", args.data_parallel),
                        ("--steps-per-dispatch > 1",
                         args.steps_per_dispatch > 1),
                        ("--device-corpus", args.device_corpus)):
        if asked:
            raise SystemExit(f"error: train {flag} is not ported yet to "
                             "dis_yolo_tpu_torch (ROADMAP queue A)")
    locked = tuple(range(1, 53)) if args.stage == 1 else ()
    cfg = _make_cfg(args, locked_layers=locked, max_iter=args.max_iter,
                    save_iter=args.save_iter, summary_iter=args.summary_iter)
    evaluator = val = None
    if not args.no_validation:
        evaluator = Evaluator(cfg, "val")
        val = DefectValData(cfg, "val")
    solver = Solver(cfg, evaluator=evaluator, val_data=val, seed=args.seed,
                    restore=args.restore, weights_from=args.weights_from,
                    tf1_weights=args.tf1_weights, device=args.device)
    solver.train()
    return solver


def cmd_eval(args):
    from dis_yolo_tpu_torch.data.val_data import DefectValData
    from dis_yolo_tpu_torch.eval.map_eval import Evaluator
    from dis_yolo_tpu_torch.eval.sweep import run_split
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.train import checkpoint as ckpt

    if args.data_parallel:
        raise SystemExit("error: eval --data-parallel is not ported yet to "
                         "dis_yolo_tpu_torch (ROADMAP queue A)")
    cfg = _make_cfg(args)
    model = api.init_model(cfg, 0, device=args.device)
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
                                  device=args.device)
        scales = calibrate_deploy(cmodel, dv, calib,
                                  use_pct=args.quant_calib == "pct")
        model = api.create_model(cfg.replace(quant=True), device=args.device)
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
        device=args.device)
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


def cmd_not_ported(args):
    print(f"dis_yolo_tpu_torch: '{args.command}' is not ported yet (it needs "
          "the export path and the overlay renderer, ROADMAP A.6); use "
          "python -m dis_yolo_tpu.cli for it", file=sys.stderr)
    return 2


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
                   help="not ported yet")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K > 1 is not ported yet")
    p.add_argument("--device-corpus", action="store_true",
                   help="not ported yet")
    p.add_argument("--no-validation", action="store_true")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="mask mAP@0.5 + mIoU on a split")
    _add_common(p)
    p.add_argument("--phase", default="test", choices=["val", "test"])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--data-parallel", action="store_true",
                   help="not ported yet")
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

    for name in NOT_PORTED:
        p = sub.add_parser(name, help="not ported yet")
        p.set_defaults(fn=cmd_not_ported)

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

    args, unknown = parser.parse_known_args(argv)
    if unknown and args.fn is not cmd_not_ported:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args.fn(args)


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)

"""The port's serving commands end to end on the CPU, on a small split
stored as P6, held against the JAX package's serving pipeline on the same
bridged weights and images: ``cli infer`` through the BN-folded graph of
a checkpoint, the int8 graph and exported artifacts (a fixed batch,
padded to, and a dynamic batch, served at B=1), and ``cli export``
(deploy and int8).

What each command hands to the post-processing (one image's detections
and masks, its size, the net size), to the renderer (the image and its
class names) and to the calibration (the images and the scales) is
recorded and compared with the JAX package's ``fold_batchnorm`` /
``deploy_variables`` + ``calibrate_deploy`` + ``quantize_deploy`` +
forward + predict + ``detections_to_original`` on the same inputs.  The
commands build their config at the default bfloat16 convolutions; here
they build it at float32 (``cli._make_cfg`` wrapped), so that the float
graphs agree with JAX within predict's float32 tolerance (atol 2e-5,
``tests/test_torch_predict.py``).  The int8 routes calibrate on the
images JAX's would, to JAX's scales within rtol 1e-5, and serve JAX's
int8 tree of them (``tests/test_torch_quant.py``).
Every overlay is ``<stem>.png`` at the input's size.

A full-width checkpoint or float32 artifact is about 0.25 GB at any
image size: all of them are removed after the module."""

import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.data import val_data as jax_val_data
from dis_yolo_tpu.eval.postprocess import \
    detections_to_original as jax_to_original
from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu.models import fold as jax_fold
from dis_yolo_tpu.models import quant as jax_quant
from dis_yolo_tpu_torch import cli
from dis_yolo_tpu_torch.data import image_io
from dis_yolo_tpu_torch.eval import postprocess
from dis_yolo_tpu_torch.models import quant
from dis_yolo_tpu_torch.models.weights import (flax_from_state_dict,
                                               state_dict_from_flax)
from dis_yolo_tpu_torch.utils import visualize
from tests.test_torch_model import (as_numpy_tree, assert_tree_equal,
                                    random_variables)
from tests.test_torch_predict import assert_slice_matches_jax, jax_reference
from tests.test_torch_visualize import make_split, read_png

SIZE = 64
COMMON = ["--image-size", str(SIZE), "--device", "cpu"]
THRESH = "0.01"         # random weights: push real detections through


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _float32(monkeypatch):
    make = cli._make_cfg
    monkeypatch.setattr(cli, "_make_cfg", lambda args, **kw: make(
        args, compute_dtype="float32", **kw))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A train and a val split (P6), seed-3 Flax weights and a checkpoint
    of them bridged to the port; everything removed after the module."""
    root = str(tmp_path_factory.mktemp("serving"))
    make_split(root, {"train": 4, "val": 3}, sizes=((60, 80), (80, 60)))
    jcfg = JaxConfig(dataset=root, image_size=SIZE, test_size=SIZE,
                     batch_size=1, compute_dtype="float32")
    variables = jax.tree.map(np.asarray, random_variables(jcfg, 3))
    ckpt = os.path.join(root, "ckpt")
    os.makedirs(ckpt)
    torch.save(state_dict_from_flax(variables), os.path.join(ckpt, "weights"))
    yield root, ckpt, jcfg, variables
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture
def seen(monkeypatch):
    """Records the arguments of ``detections_to_original``,
    ``draw_instances`` and ``calibrate_deploy``, and the int8 tree of
    ``quantize_deploy``, as the commands call them (each command imports
    them when it runs)."""
    rec = {"post": [], "drawn": [], "calib": [], "int8": []}
    to_original = postprocess.detections_to_original
    draw, calibrate = visualize.draw_instances, quant.calibrate_deploy
    quantize = quant.quantize_deploy

    def post(dets, masks, h, w, size, *a, **kw):
        rec["post"].append((dets, masks, h, w, size))
        return to_original(dets, masks, h, w, size, *a, **kw)

    def drawn(rgb, instances):
        rec["drawn"].append((rgb, [i["classname"] for i in instances]))
        return draw(rgb, instances)

    def calib(model, deploy_sd, images, use_pct=False):
        scales = calibrate(model, deploy_sd, images, use_pct=use_pct)
        rec["calib"].append((np.asarray(images), use_pct, scales))
        return scales

    def quantized(deploy_sd, scales):
        state = quantize(deploy_sd, scales)
        rec["int8"].append(state)
        return state

    monkeypatch.setattr(postprocess, "detections_to_original", post)
    monkeypatch.setattr(visualize, "draw_instances", drawn)
    monkeypatch.setattr(quant, "calibrate_deploy", calib)
    monkeypatch.setattr(quant, "quantize_deploy", quantized)
    return rec


def letterboxed(root, phase="val"):
    """The split's images (read as the commands read them) and the JAX
    package's letterbox of each: [(rgb, canvas, window)]."""
    folder = os.path.join(root, phase, "images")
    rgbs = [image_io.read_image(os.path.join(folder, f))
            for f in sorted(os.listdir(folder))]
    return [(rgb, *jax_val_data.letterbox_image(rgb, SIZE)) for rgb in rgbs]


def jax_serve(jcfg, variables, images, quant_scales=None):
    """The JAX package's serving graph on each image: BN-folded, or int8
    with ``quant_scales``.  -> {assembly: [(dets, masks, h, w)]}: masks
    from its Pallas assembly in interpret mode (True, the formulation of
    the port's K1, which ``infer --checkpoint`` runs on every device), and
    from its gather route (False, what a CPU artifact exports, as JAX's
    ``export_predict`` does off the TPU)."""
    if quant_scales is None:
        model = jax_api.create_model(jcfg)
        v = jax_fold.fold_batchnorm(model, variables)
    else:
        model = jax_api.create_model(jcfg.replace(quant=True))
        v = jax_quant.quantize_deploy(jax_fold.deploy_variables(variables),
                                      quant_scales)
    fwd = jax.jit(lambda v_, x: model.apply(v_, x, train=False))
    gather = jax.jit(lambda r, w: jax_api.predict_from_outputs(
        jcfg, r, w, float(THRESH), pallas=False))
    out = {True: [], False: []}
    for rgb, canvas, window in images:
        raws = [np.asarray(r) for r in fwd(v, jnp.asarray(canvas[None]))]
        h, w = rgb.shape[:2]
        dets, masks = jax_reference(jcfg, raws, window[None], float(THRESH))
        out[True].append((dets[0], masks[0], h, w))
        dets, masks = gather([jnp.asarray(r) for r in raws],
                             jnp.asarray(window[None]))
        out[False].append((np.asarray(dets[0]), np.asarray(masks[0]), h, w))
    return out


def jax_scales(jcfg, variables, canvases):
    cmodel = jax_api.create_model(jcfg.replace(quant=True,
                                               quant_calibrate=True))
    return jax_quant.calibrate_deploy(
        cmodel, jax_fold.deploy_variables(variables), jnp.asarray(canvases),
        use_pct=True)


@pytest.fixture(scope="module")
def reference(work):
    """The JAX package's BN-folded serving graph on the val split."""
    root, _, jcfg, variables = work
    return jax_serve(jcfg, variables, letterboxed(root))


def assert_served_as(rec, jcfg, want, atol=2e-5):
    """Each image went through predict, post-processing and rendering
    as ``want`` (the JAX pipeline's per-image outputs) did."""
    assert len(rec["post"]) == len(rec["drawn"]) == len(want)
    for (dets, masks, h, w, size), (rgb, names), (jd, jm, jh, jw) in zip(
            rec["post"], rec["drawn"], want):
        assert (h, w, size) == (jh, jw, SIZE) and rgb.shape == (h, w, 3)
        assert_slice_matches_jax(dets, masks, jd, jm, atol=atol)
        assert names == [jcfg.classes[i["classid"]] for i in
                         jax_to_original(jd, jm, jh, jw, SIZE)]


def assert_calibrated_as(rec, jcfg, variables, canvases):
    """One calibration, on ``canvases`` with percentile scales, giving
    JAX's scales on them, and one int8 tree, JAX's ``quantize_deploy``
    of the port's scales leaf for leaf."""
    (images, use_pct, scales), = rec["calib"]
    np.testing.assert_allclose(images, canvases, rtol=0, atol=1e-6)
    assert use_pct
    want = jax_scales(jcfg, variables, canvases)
    assert set(scales) == set(want)
    for name in want:
        np.testing.assert_allclose(scales[name], want[name], rtol=1e-5,
                                   err_msg=name)
    (state,) = rec["int8"]
    assert_tree_equal(flax_from_state_dict(state), as_numpy_tree(
        jax_quant.quantize_deploy(jax_fold.deploy_variables(variables),
                                  scales)))


def infer(capsys, root, out, *extra):
    """Run ``cli infer`` over the val images -> {stem: detections}; each
    overlay decodes to its input's shape."""
    cli.main(["infer", "--images", os.path.join(root, "val", "images"),
              "--out", out, "--dataset", root] + COMMON + list(extra))
    counts = {}
    for line in capsys.readouterr().out.splitlines():
        m = re.match(r"(.+): (\d+) detections -> (.+) \([\d.]+ ms\)$", line)
        if m:
            stem = os.path.splitext(os.path.basename(m.group(1)))[0]
            counts[stem] = int(m.group(2))
            assert m.group(3) == os.path.join(out, stem + ".png")
    assert sorted(os.listdir(out)) == [f"val{i:04d}.png" for i in range(3)]
    for i, shape in enumerate(((60, 80, 3), (80, 60, 3), (60, 80, 3))):
        assert read_png(os.path.join(out, f"val{i:04d}.png")).shape == shape
    return counts


def export(capsys, root, ckpt, prefix, *extra):
    cli.main(["export", "--out", prefix, "--checkpoint", ckpt,
              "--threshold", THRESH, "--dataset", root] + COMMON
             + list(extra))
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["artifact"] == prefix + ".pt2" and report["device"] == "cpu"
    assert report["bytes"] == os.path.getsize(prefix + ".pt2")
    with open(prefix + ".json") as f:
        meta = json.load(f)
    return report, meta


def test_infer_checkpoint_route(work, reference, seen, capsys):
    """``infer --checkpoint`` serves the BN-folded graph of the
    checkpoint: JAX's detections and masks on every image."""
    root, ckpt, jcfg, _ = work
    counts = infer(capsys, root, os.path.join(root, "out_ckpt"),
                   "--checkpoint", ckpt, "--threshold", THRESH)
    assert sum(counts.values()) > 0
    assert_served_as(seen, jcfg, reference[True])


@pytest.mark.parametrize("batch", ["fixed", "dynamic"])
def test_export_and_infer_artifact(work, reference, seen, capsys, batch):
    """``export`` writes the deploy graph at a fixed batch (the JAX flags'
    default ``--batch-size 2``, padded to) or a dynamic one (``--symbolic-
    batch``, served at B=1); ``infer --artifact`` serves JAX's detections
    and masks, with the size and class names of the artifact's meta."""
    root, ckpt, jcfg, _ = work
    prefix = os.path.join(root, f"deploy_{batch}")
    extra = ["--symbolic-batch"] if batch == "dynamic" else []
    report, meta = export(capsys, root, ckpt, prefix, *extra)
    want_b = "b" if batch == "dynamic" else 2
    assert report["batch_size"] == want_b and report["image_size"] == SIZE
    assert meta["in_shapes"] == [[want_b, SIZE, SIZE, 3], [want_b, 4]]
    assert meta["quant"] is False and meta["checkpoint"] == ckpt
    assert meta["config"]["deploy"] is True and meta["obj_thresh"] == 0.01
    got = infer(capsys, root, os.path.join(root, f"out_{batch}"),
                "--artifact", prefix)
    assert sum(got.values()) > 0
    assert_served_as(seen, jcfg, reference[False])
    os.remove(prefix + ".pt2")


def test_int8_export_and_infer(work, seen, capsys):
    """``infer --quant`` calibrates on its first (up to 8) letterboxed
    inputs and ``export --quant`` on the train split, each to JAX's
    percentile scales on the same images, and each serves the int8 tree
    that JAX's ``quantize_deploy`` makes of those scales, leaf for leaf.
    The int8 detections are not held to JAX's: a graph with ulp-level
    differences ahead of its first int8 layer flips quantization steps
    that cascade (``tests/test_torch_quant.py``); on this split the two
    graphs' boxes lie up to 0.07 apart."""
    root, ckpt, jcfg, variables = work
    counts = infer(capsys, root, os.path.join(root, "out_quant"),
                   "--checkpoint", ckpt, "--threshold", THRESH, "--quant")
    assert min(counts.values()) > 0
    val = np.stack([c for _, c, _ in letterboxed(root)[:8]])
    assert_calibrated_as(seen, jcfg, variables, val)
    for (dets, masks, h, w, size), (_, names) in zip(seen["post"],
                                                     seen["drawn"]):
        assert names == [jcfg.classes[i["classid"]] for i in
                         jax_to_original(dets, masks, h, w, size)]
    prefix = os.path.join(root, "int8")
    for key in seen:
        seen[key].clear()
    report, meta = export(capsys, root, ckpt, prefix, "--quant",
                          "--batch-size", "1")
    assert meta["quant"] is True and meta["config"]["quant"] is True
    assert report["bytes"] < 0.5 * 4 * 62e6       # int8 weights
    train = jax_val_data.DefectValData(jcfg, "train").get()[0][:8]
    assert_calibrated_as(seen, jcfg, variables, train)
    got = infer(capsys, root, os.path.join(root, "out_int8"),
                "--artifact", prefix)
    assert min(got.values()) > 0
    os.remove(prefix + ".pt2")
    with pytest.raises(SystemExit, match="train split"):
        cli.main(["export", "--out", prefix, "--quant", "--dataset",
                  os.path.join(root, "nowhere")] + COMMON)

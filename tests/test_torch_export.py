"""Port parity of the serving export (``dis_yolo_tpu_torch/export.py``)
on the CPU: saved and reloaded artifacts against the JAX package's.

The deploy graph of one numpy-drawn weight set is exported on both sides
at 64 px, float32, top-64: the port's artifact with the gather assembly
against the JAX package's ``export_predict(..., pallas=False)`` artifact
at B=1 and at a dynamic batch served at B=1, 2 and 3; the port's K1
artifact against its live predict and against JAX's live predict with
the Pallas assembly in interpret mode.  Tolerances are those of
``tests/test_torch_predict.py`` (atol 2e-5 at float32).  The eager
gather route and NMS's exported control flow are held against JAX in
``tests/test_torch_export_nms.py``.

A full-width artifact holds 62 M float32 weights at any image size
(about 0.25 GB): the artifacts are removed after use.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu import export as jax_exp
from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu.models import fold as jax_fold
from dis_yolo_tpu.ops.pallas_assembly import assemble_masks_batch_pallas
from dis_yolo_tpu_torch import export as exp
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api, fold
from dis_yolo_tpu_torch.models.weights import state_dict_from_flax
from tests.test_torch_model import random_variables
from tests.test_torch_ops import T, assert_dets_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(image_size=64, test_size=64, pre_nms_top_k=64,
          compute_dtype="float32")
THRESH = 1e-3           # random weights: push real detections through
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def deploy_setup():
    """Both sides' deploy graphs of one numpy-drawn weight set, and seeded
    images and windows for batches of 1, 2 and 3."""
    jcfg = JaxConfig(**KW).replace(deploy=True)
    cfg = DISYoloConfig(**KW).replace(deploy=True)
    variables = jax.tree.map(np.asarray, random_variables(JaxConfig(**KW), 3))
    jvars = jax_fold.deploy_variables(variables)
    model = api.create_model(cfg, device="cpu")
    model.load_state_dict(fold.deploy_variables(state_dict_from_flax(variables)))
    rng = np.random.RandomState(4)
    inputs = {}
    for b in (1, 2, 3):
        images = rng.rand(b, 64, 64, 3).astype(np.float32)
        windows = np.tile(np.array([[0.0, 0.1, 1.0, 0.9]], np.float32), (b, 1))
        windows[0] = [0.0, 0.0, 1.0, 1.0]
        inputs[b] = (images, windows)
    return cfg, model, jcfg, jvars, inputs


@pytest.fixture(scope="module")
def k1_artifact(deploy_setup, tmp_path_factory):
    """The port's K1 artifact at B=1, saved (removed after the module),
    and its graph's code."""
    cfg, model = deploy_setup[:2]
    path = str(tmp_path_factory.mktemp("k1") / "deploy_k1")
    ep = exp.export_predict(cfg, model, 1, obj_thresh=THRESH, device="cpu",
                            pallas=True)
    exp.save_artifact(ep, path, cfg, obj_thresh=THRESH)
    yield path, str(ep.graph)
    for ext in (".pt2", ".json"):
        os.remove(path + ext)


@pytest.fixture(scope="module")
def jax_artifact(deploy_setup, tmp_path_factory):
    """The JAX package's gather artifact at a dynamic batch, saved and
    reloaded: its meta, and its outputs at B=1, 2 and 3."""
    jcfg, jvars, inputs = deploy_setup[2:]
    path = str(tmp_path_factory.mktemp("jax") / "gather")
    exported = jax_exp.export_predict(jcfg, jvars, batch_size="b",
                                      obj_thresh=THRESH, pallas=False)
    jax_exp.save_artifact(exported, path, jcfg, obj_thresh=THRESH)
    run, meta = jax_exp.load_artifact(path)
    os.remove(path + ".stablehlo")
    os.remove(path + ".json")
    outs = {b: [np.asarray(x) for x in run(jnp.asarray(images),
                                           jnp.asarray(windows))]
            for b, (images, windows) in inputs.items()}
    return meta, outs


def assert_outputs_match(got, want, atol=ATOL):
    dets, masks = (np.asarray(x) for x in got)
    wdets, wmasks = (np.asarray(x) for x in want)
    assert_dets_match(dets, wdets, atol)
    np.testing.assert_allclose(masks, wmasks, rtol=0, atol=atol)


@pytest.mark.parametrize("batch", [1, "b"])
def test_gather_artifact_matches_jax_artifact(deploy_setup, jax_artifact,
                                              tmp_path, batch):
    """``pallas=False``: the port's artifact (fixed B=1, or a dynamic batch
    served at 1, 2 and 3) against the JAX package's dynamic-batch one,
    from the same weights; valid rows read 0.5 outside their box."""
    cfg, model, _, _, inputs = deploy_setup
    jmeta, jouts = jax_artifact
    ep = exp.export_predict(cfg, model, batch, obj_thresh=THRESH,
                            device="cpu", pallas=False)
    path = str(tmp_path / "gather")
    blob = exp.save_artifact(ep, path, cfg, obj_thresh=THRESH,
                             extra_meta={"note": "test"})
    del ep
    run, meta = exp.load_artifact(path)
    os.remove(blob)
    for key in ("format_version", "obj_thresh", "config"):
        assert meta[key] == jmeta[key], key
    assert meta["note"] == "test" and meta["device"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    want_shapes = [[batch] + d[1:] for d in jmeta["in_shapes"]]
    assert meta["in_shapes"] == want_shapes == [[batch, 64, 64, 3], [batch, 4]]
    assert meta["out_shapes"] == [[batch] + d[1:] for d in jmeta["out_shapes"]]
    for b in ((1,) if batch == 1 else (1, 2, 3)):
        images, windows = inputs[b]
        got = run(T(images), T(windows))
        assert_outputs_match(got, jouts[b])
        valid = np.asarray(got[0][..., 5]) > 0
        assert valid.sum() >= 10 * b
        masks = np.asarray(got[1])
        assert np.any(masks[valid] == 0.5) and np.all(masks[~valid] == 0)


def jax_live_k1(jcfg, jvars, images, windows):
    """JAX's live predict with the Pallas assembly in interpret mode."""
    model = jax_api.create_model(jcfg)
    raws = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        jvars, jnp.asarray(images))
    dets, _ = jax.jit(lambda r, w: jax_api.predict_from_outputs(
        jcfg, r, w, THRESH, pallas=False))(raws, jnp.asarray(windows))
    masks = assemble_masks_batch_pallas(raws[3], dets[..., :4], jcfg.k_map,
                                        interpret=True)
    valid = np.asarray(dets[..., 5] > 0)
    return np.asarray(dets), np.asarray(masks) * valid[..., None, None]


@pytest.fixture(scope="module")
def k1_loaded(k1_artifact):
    return exp.load_artifact(k1_artifact[0])


def test_k1_artifact_matches_live_predict(deploy_setup, k1_artifact,
                                          k1_loaded):
    """``pallas=True``: K1 (its CPU registration) in the artifact equals
    the port's live predict bit for bit and JAX's Pallas route within
    atol; 0 outside every box."""
    cfg, model, jcfg, jvars, inputs = deploy_setup
    run, meta = k1_loaded
    assert meta["in_shapes"] == [[1, 64, 64, 3], [1, 4]]
    assert meta["out_shapes"] == [[1, 30, 6], [1, 30, 32, 32]]
    images, windows = inputs[1]
    got = run(T(images), T(windows))
    live = api.predict(model, images, windows, THRESH, device="cpu")
    for g, w in zip(got, live):
        assert torch.equal(g, w)
    assert_outputs_match(got, jax_live_k1(jcfg, jvars, images, windows))
    graph = k1_artifact[1]
    assert "dis_yolo.assemble_masks" in graph
    assert "while_loop" in graph and "cond" in graph
    assert "_assert_tensor_metadata" not in graph


LOADER = """
import json, sys
import numpy as np
import torch
from dis_yolo_tpu_torch.export import load_artifact
run, meta = load_artifact(sys.argv[1])
data = np.load(sys.argv[2])
dets, masks = run(torch.from_numpy(data["images"]),
                  torch.from_numpy(data["windows"]))
np.savez(sys.argv[3], dets=dets.numpy(), masks=masks.numpy())
print(json.dumps({"models": sorted(m for m in sys.modules
                                   if m.startswith("dis_yolo_tpu_torch.models")),
                  "jax": "jax" in sys.modules}))
"""


def test_artifact_loads_without_model_code(deploy_setup, k1_artifact,
                                           tmp_path):
    """A fresh process that imports torch and ``export.load_artifact``
    (which imports ``ops.custom_ops``) serves the artifact; the port's
    model code never enters ``sys.modules``, and the outputs equal the
    live predict."""
    cfg, model, _, _, inputs = deploy_setup
    images, windows = inputs[1]
    np.savez(tmp_path / "in.npz", images=images, windows=windows)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", LOADER, k1_artifact[0], str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"models": [], "jax": False}
    out = np.load(tmp_path / "out.npz")
    dets, masks = api.predict(model, images, windows, THRESH, device="cpu")
    np.testing.assert_array_equal(out["dets"], dets.numpy())
    np.testing.assert_array_equal(out["masks"], masks.numpy())


def test_artifact_rejects_other_shapes(k1_loaded):
    """Inputs outside the exported shapes raise: another batch for a
    fixed-batch artifact, another image size."""
    run, _ = k1_loaded
    for b, size in ((2, 64), (1, 96)):
        with pytest.raises(Exception):
            run(torch.zeros((b, size, size, 3)), torch.zeros((b, 4)))


def test_export_refuses_a_model_elsewhere(deploy_setup):
    cfg, model = deploy_setup[:2]
    with pytest.raises(ValueError, match="expected meta"):
        exp.export_predict(cfg, model, 1, device="meta")

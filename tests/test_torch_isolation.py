"""The port's boundaries: it imports nothing of JAX or the JAX package,
never drifts to the CPU, refuses what it has not ported, and its CUDA
wrappers never fall back."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.ops import _build
from dis_yolo_tpu_torch.ops.cuda_assembly import (assemble_bwd_cuda,
                                                  assemble_masks_cuda,
                                                  extract_planes_cuda)
from dis_yolo_tpu_torch.ops.custom_ops import (assemble_masks_batch_cuda,
                                               nms_cuda)
from dis_yolo_tpu_torch.parallel.sharding import make_mesh
from dis_yolo_tpu_torch.train import train_step


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dis_yolo_tpu")


def _port_files():
    return sorted((ROOT / "dis_yolo_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    port = ROOT / "dis_yolo_tpu_torch"
    for module in ("models/fold.py", "models/s2d.py", "models/quant.py",
                   "ops/cuda_assembly.py",       # K4's wrapper lives here
                   "eval/sweep.py", "eval/map_eval.py", "eval/voc_eval.py",
                   "eval/postprocess.py", "data/val_data.py",
                   "data/rasterize.py", "data/augment.py",
                   # the training loop
                   "data/dataset.py", "data/image_io.py",
                   "data/preprocess.py", "data/synthetic.py",
                   "native/__init__.py", "train/checkpoint.py",
                   "train/solver.py", "train/tensorbundle.py",
                   "utils/timer.py", "utils/metrics_log.py",
                   "utils/profiling.py", "utils/runtime.py", "cli.py",
                   # the serving export
                   "export.py", "ops/custom_ops.py", "utils/visualize.py",
                   # the data-parallel layer
                   "parallel/__init__.py", "parallel/distributed.py",
                   "parallel/sharding.py"):
        assert port / module in files, module
    # chip_smoke's worker processes run from the same file
    assert "--dp-worker" in (ROOT / "chip_smoke.py").read_text()
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_no_cv2_at_module_level():
    """The card's machine has no OpenCV: importing any module of the port
    must not need it (``DefectValData`` imports it when it decodes)."""
    for path in _port_files():
        tree = ast.parse(path.read_text(), str(path))
        top = [node for node in tree.body
               if isinstance(node, (ast.Import, ast.ImportFrom, ast.Try))]
        roots = set()
        for node in top:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Import):
                    roots |= {a.name.split(".")[0] for a in sub.names}
                elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
                    roots.add(sub.module.split(".")[0])
        assert not roots & {"cv2", "PIL"}, path.relative_to(ROOT)


def test_entry_points_raise_without_cuda(monkeypatch):
    """Without a card, every entry point called without device='cpu'
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DISYoloConfig(image_size=64)
    for call in (lambda: api.create_model(cfg),
                 lambda: api.init_model(cfg, seed=0),
                 lambda: api.create_model(cfg, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = api.create_model(cfg, device="cpu")
    images = np.zeros((1, 64, 64, 3), np.float32)
    windows = np.array([[0.0, 0.0, 1.0, 1.0]], np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.predict(model, images, windows)
    raws = api.forward(model, images, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.predict_from_outputs(cfg, raws, windows)
    dets, masks = api.predict(model, images, windows, device="cpu")
    assert dets.device.type == masks.device.type == "cpu"
    from dis_yolo_tpu_torch.data import device_corpus
    aug_model = api.create_model(cfg.replace(device_side_augs=True),
                                 device="cpu")
    host = device_corpus.HostCorpus(*(np.zeros(s, d) for s, d in (
        ((1, 8, 8, 3), np.uint8), ((1, 20, 8), np.uint8), ((1, 2), np.int32),
        ((1, 20, 4), np.float32), ((1, 20), np.int32), ((1,), np.int32))))
    for call in (lambda: train_step.init_train_state(model),
                 lambda: train_step.make_train_step(model),
                 lambda: train_step.make_multi_step(model),
                 lambda: train_step.make_corpus_multi_step(aug_model),
                 lambda: device_corpus.upload_corpus(host)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert device_corpus.upload_corpus(host, "cpu")["sizes"].device.type \
        == "cpu"
    state = train_step.init_train_state(model, device="cpu")
    assert callable(train_step.make_train_step(model, device="cpu"))
    assert state.step == 0 and state.opt.count == 0


def test_entry_points_reject_tensors_on_another_device():
    cfg = DISYoloConfig(image_size=64)
    model = api.create_model(cfg, device="cpu")
    images = torch.zeros((1, 64, 64, 3), device="meta")
    with pytest.raises(ValueError, match="expected cpu"):
        api.forward(model, images, device="cpu")


# the serving graphs: ported for inference, refused by the train step
SERVING_GRAPH_FIELDS = ("deploy", "quant", "quant_calibrate", "s2d_stem")


@pytest.mark.parametrize("field,value", [
    ("use_pallas_assembly", False), ("deploy", True), ("quant", True),
    ("quant_calibrate", True), ("s2d_stem", True), ("remat", True),
    ("decoder_commute", True)])
def test_unported_config_raises(field, value):
    """Every graph variant is ported now.  The four serving-graph fields
    build and serve, and check_trainable and the train entry points
    refuse them (s2d_stem needs deploy=True, else ValueError as in JAX).
    remat and decoder_commute build, serve the default's detections and
    train (``tests/test_torch_train_knobs.py`` holds their numbers).
    use_pallas_assembly=False serves the gather assembly (0.5 outside
    the box on valid rows) and trains as the default does."""
    cfg = DISYoloConfig(image_size=64)
    bad = cfg.replace(**{field: value})
    raws = [np.zeros((1, g, g, 3, 8), np.float32) for g in cfg.grid_sizes()]
    raws.append(np.zeros((1, 32, 32, 9), np.float32))
    windows = np.array([[0.0, 0.0, 1.0, 1.0]], np.float32)
    if field == "use_pallas_assembly":
        bad.check_trainable()
        model = api.create_model(bad, device="cpu")
        assert callable(train_step.make_train_step(model, device="cpu"))
        # threshold 0: every candidate passes, every logit is 0
        dets, masks = api.predict_from_outputs(bad, raws, windows, 0.0,
                                               device="cpu")
        _, k1_masks = api.predict_from_outputs(cfg, raws, windows, 0.0,
                                               device="cpu")
        valid = dets[0, :, 5] > 0
        assert 0 < int(valid.sum()) < 30
        assert bool((masks[0][valid] == 0.5).all())
        assert bool((masks[0][~valid] == 0).all())
        inside = k1_masks[0][valid] != 0
        assert bool((k1_masks[0][valid][inside] == 0.5).all())
        assert bool((~inside).any()) and bool((k1_masks[0][~valid] == 0).all())
        return
    if field in SERVING_GRAPH_FIELDS:
        with pytest.raises(NotImplementedError, match=field):
            bad.check_trainable()
        if field == "s2d_stem":
            with pytest.raises(ValueError, match="s2d_stem requires deploy"):
                api.create_model(bad, device="cpu")
            bad = bad.replace(deploy=True)
        model = api.create_model(bad, device="cpu")
        images = np.zeros((1, 64, 64, 3), np.float32)
        dets, masks = api.predict(model, images, windows, device="cpu")
        assert dets.shape == (1, 30, 6) and masks.shape == (1, 30, 32, 32)
        for call in (lambda: train_step.init_train_state(model, device="cpu"),
                     lambda: train_step.make_train_step(model, device="cpu")):
            with pytest.raises(NotImplementedError, match="train step"):
                call()
        return
    # remat, decoder_commute: trainable graphs with the default's names
    bad.check_trainable()
    model = api.init_model(bad, 0, device="cpu")
    plain = api.init_model(cfg, 0, device="cpu")
    assert list(model.state_dict()) == list(plain.state_dict())
    images = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    dets, masks = api.predict(model, images, windows, 0.0, device="cpu")
    want, _ = api.predict(plain, images, windows, 0.0, device="cpu")
    assert dets.shape == (1, 30, 6) and masks.shape == (1, 30, 32, 32)
    assert torch.equal(dets[..., 5], want[..., 5])
    torch.testing.assert_close(dets, want, rtol=1e-4, atol=1e-5)
    assert callable(train_step.make_train_step(model, device="cpu"))


@pytest.mark.parametrize("field,value", [
    ("grad_accum", 2), ("remat", True), ("device_side_augs", True),
    ("device_corpus", True), ("steps_per_dispatch", 4), ("bn_axis", "dp"),
    ("device_corpus_without_augs", True)])
def test_unported_training_knob_raises(field, value):
    """The training knobs are ported: check_trainable accepts them and
    the train entry points build (device_corpus with the device-side augs
    it needs; without them a ValueError).  Sync-BN (bn_axis) is the mesh
    step's: without a mesh of that axis it is a ValueError in
    check_trainable and at the train entry points; with one, they
    build."""
    cfg = DISYoloConfig(image_size=64)
    cfg.check_trainable()
    if field == "device_corpus_without_augs":
        bad = cfg.replace(device_corpus=True)
        with pytest.raises(ValueError, match="device_side_augs"):
            bad.check_trainable()
        model = api.create_model(cfg, device="cpu")
        model.cfg = bad
        with pytest.raises(ValueError, match="device_side_augs"):
            train_step.make_train_step(model, device="cpu")
        return
    knob = cfg.replace(**{field: value})
    if field == "device_corpus":
        knob = knob.replace(device_side_augs=True)
    if field != "bn_axis":
        knob.check_trainable()
        model = api.create_model(knob, device="cpu")
        state = train_step.init_train_state(model, device="cpu")
        assert state.step == 0 and state.opt.mu
        assert callable(train_step.make_train_step(model, device="cpu"))
        assert callable(train_step.make_multi_step(model, device="cpu"))
        if knob.device_side_augs:
            assert callable(train_step.make_corpus_multi_step(model,
                                                              device="cpu"))
        return
    with pytest.raises(ValueError, match=field):
        knob.check_trainable()
    model = api.create_model(cfg, device="cpu")
    model.cfg = knob
    for call in (lambda: train_step.init_train_state(model, device="cpu"),
                 lambda: train_step.make_train_step(model, device="cpu")):
        with pytest.raises(ValueError, match=field):
            call()
    mesh = make_mesh("cpu")
    knob.check_trainable(mesh)
    state = train_step.init_train_state(model, mesh=mesh)
    assert state.step == 0 and state.opt.mu
    for make in (train_step.make_train_step, train_step.make_multi_step):
        assert callable(make(model, mesh=mesh))


def test_cuda_wrappers_never_fall_back(monkeypatch):
    """CPU tensors take the plain version without building anything; any
    other placement raises before a kernel is built, never falls back."""
    def no_build(name):
        raise AssertionError(f"kernel {name} built for a non-CUDA call")
    monkeypatch.setattr(_build, "load", no_build)

    sm = torch.zeros((1, 8, 8, 9))
    bx = torch.zeros((1, 3, 4))
    before = assemble_masks_batch_cuda.launches
    assert assemble_masks_batch_cuda(sm, bx, 3).shape == (1, 3, 8, 8)
    assert assemble_masks_batch_cuda.launches == before
    for args in ((sm.to("meta"), bx), (sm, bx.to("meta")),
                 (sm.to("meta"), bx.to("meta"))):
        with pytest.raises(ValueError, match="CUDA device"):
            assemble_masks_batch_cuda(*args, 3)
    with pytest.raises(ValueError, match=r"\[B,S,S,9\]"):
        assemble_masks_batch_cuda(torch.zeros((1, 8, 8, 4)), bx, 3)

    g = torch.zeros((1, 3, 8, 8))
    before = assemble_bwd_cuda.launches
    assert assemble_bwd_cuda(bx, g, 3).shape == (1, 8, 8, 9)
    assert assemble_bwd_cuda.launches == before
    for args in ((bx.to("meta"), g), (bx, g.to("meta")),
                 (bx.to("meta"), g.to("meta"))):
        with pytest.raises(ValueError, match="CUDA device"):
            assemble_bwd_cuda(*args, 3)
    with pytest.raises(ValueError, match=r"boxes_px \[B,R,4\]"):
        assemble_bwd_cuda(torch.zeros((1, 2, 4)), g, 3)
    with pytest.raises(ValueError, match="R <= 256"):
        assemble_bwd_cuda(torch.zeros((1, 300, 4)),
                          torch.zeros((1, 300, 8, 8)), 3)

    boxes = torch.zeros((1, 16, 4))
    scores = torch.zeros((1, 16))
    classes = torch.zeros((1, 16), dtype=torch.int32)
    valid = torch.ones((1, 16), dtype=torch.bool)
    before = nms_cuda.launches
    assert nms_cuda(boxes, scores, classes, valid, 5, 0.3).shape == (1, 5)
    assert nms_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        nms_cuda(boxes.to("meta"), scores, classes, valid, 5, 0.3)
    with pytest.raises(ValueError, match="K <= 1024"):
        nms_cuda(torch.zeros((1, 2048, 4)), torch.zeros((1, 2048)),
                 torch.zeros((1, 2048), dtype=torch.int32),
                 torch.ones((1, 2048), dtype=torch.bool), 5, 0.3)


def test_extract_wrapper_never_falls_back(monkeypatch):
    """K4's wrapper and the single-image assembly: CPU tensors take the
    plain versions without building anything, other placements and bad
    shapes or dtypes raise."""
    def no_build(name):
        raise AssertionError(f"kernel {name} built for a non-CUDA call")
    monkeypatch.setattr(_build, "load", no_build)

    sm2d = torch.zeros((2, 8, 8 * 9), dtype=torch.bfloat16)
    before = extract_planes_cuda.launches
    out = extract_planes_cuda(sm2d, 3)
    assert out.shape == (2, 9, 8, 8) and out.dtype == torch.float32
    assert extract_planes_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        extract_planes_cuda(sm2d.to("meta"), 3)
    with pytest.raises(ValueError, match=r"\[B,S,S\*9\]"):
        extract_planes_cuda(torch.zeros((2, 8, 8 * 4)), 3)
    sm = torch.zeros((8, 8, 9))
    bx = torch.zeros((3, 4))
    launches = (extract_planes_cuda.launches,
                assemble_masks_batch_cuda.launches)
    for use_extract in (False, True):
        assert assemble_masks_cuda(sm, bx, 3,
                                   use_extract=use_extract).shape == (3, 8, 8)
        with pytest.raises(ValueError, match="CUDA device"):
            assemble_masks_cuda(sm.to("meta"), bx, 3, use_extract=use_extract)
    assert (extract_planes_cuda.launches,
            assemble_masks_batch_cuda.launches) == launches


def test_kernel_build_is_lazy_and_keyed_by_source():
    """Importing the port builds nothing; the library name follows the
    source hash and the exactness flags are part of the build."""
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.KERNELS:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and name in path.name
        assert (_build.CSRC / f"{name}.cu").exists()
    assert _build.load.cache_info().currsize == 0


def test_solver_path_raises_without_cuda(monkeypatch, tmp_path):
    """The device prefetch and the Solver run on the card unless given
    device='cpu'; without a card they raise."""
    from dis_yolo_tpu_torch.train.solver import Solver
    from dis_yolo_tpu_torch.utils.runtime import device_prefetch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = {"images": np.zeros((1, 4, 4, 3), np.uint8)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch(iter([batch])))
    got = next(device_prefetch(iter([batch]), device="cpu"))
    assert got["images"].device.type == "cpu"
    cfg = DISYoloConfig(image_size=64, output_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Solver(cfg, data=object())
    solver = Solver(cfg, data=object(), device="cpu")
    assert solver.device.type == "cpu"
    on_mesh = Solver(cfg, data=object(), mesh=make_mesh("cpu"))
    assert on_mesh.device.type == "cpu" and on_mesh.mesh.size == 1
    with pytest.raises(ValueError, match="bn_axis"):
        Solver(cfg.replace(bn_axis="dp"), data=object(), device="cpu")
    blocked = Solver(cfg.replace(steps_per_dispatch=2, device_side_augs=True),
                     data=object(), device="cpu")
    assert blocked.aug_rng.device.type == "cpu"


def test_reader_and_native_build_raise_not_fall_back(monkeypatch, tmp_path):
    """A file that is not P6 needs OpenCV: without it the reader raises;
    a failing g++ build of the native fill raises."""
    import builtins
    import subprocess

    from dis_yolo_tpu_torch import native
    from dis_yolo_tpu_torch.data import image_io, rasterize

    path = tmp_path / "a.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0 not a PPM")
    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="OpenCV"):
        image_io.read_image(str(path))
    image_io.write_ppm(str(path), np.full((2, 3, 3), 7, np.uint8))
    assert (image_io.read_image(str(path)) == 7).all()

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **kw:
                        subprocess.CompletedProcess(a, 1, "", "bad source"))
    with pytest.raises(RuntimeError, match="build failed"):
        rasterize.fill_polygon([0, 4, 4], [0, 0, 4], 8, 8, engine="native")

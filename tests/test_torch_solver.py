"""The port's training loop on the CPU: ``train/solver.py``, ``cli.py``
and the ``stop_stage`` probe of ``models/dis_yolo.py``, at 64 px.

  * a 4-step stage-1 Solver with ``save_iter=2`` writes its metric rows,
    checkpoints, ``best.json`` and validation history;
  * ``Solver.train`` equals the same steps called by hand on the same
    batches and ROI generator, bit for bit;
  * ``restore="auto"`` resumes at step 3 with the saved state bit-equal;
  * ``Solver.validate`` on weights carried from JAX equals the JAX
    Solver's ``validate`` (float32; the detection threshold set between
    two candidate scores, as ``tests/test_torch_sweep.py`` does, and the
    ground truth every second detection so that 0 < mAP < 1);
  * every ``stop_stage`` cut equals JAX's within the forward's float32
    tolerance;
  * ``cli.main(["train", ..., "--device", "cpu"])`` runs 2 steps, and with
    ``--device-corpus --steps-per-dispatch 2`` one block of 2; the flags
    not ported exit with a clear error;
  * K-step blocks (``steps_per_dispatch``, snapped to a divisor of
    ``save_iter``) equal the default Solver's blocks of one step bit for
    bit; the corpus
    Solver trains; with ``device_side_augs`` the host loaders skip the
    host augmentation.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.eval import map_eval as jax_map_eval
from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu.models.dis_yolo import DISYolo as JaxDISYolo
from dis_yolo_tpu.train import train_step as jax_ts
from dis_yolo_tpu.train.solver import Solver as JaxSolver
from dis_yolo_tpu_torch import cli
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data import rasterize
from dis_yolo_tpu_torch.data.dataset import DefectTrainData
from dis_yolo_tpu_torch.data.val_data import DefectValData, letterbox_image
from dis_yolo_tpu_torch.eval import map_eval, sweep
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.models.dis_yolo import STOP_STAGES, DISYolo
from dis_yolo_tpu_torch.models.weights import state_dict_from_flax
from dis_yolo_tpu_torch.train import checkpoint as ckpt
from dis_yolo_tpu_torch.train import train_step as ts
from dis_yolo_tpu_torch.train.solver import Solver
from dis_yolo_tpu_torch.utils.runtime import calibrate_threshold
from tests.test_torch_model import as_numpy_tree, random_variables
from tests.test_torch_eval import jax_numpy_fill  # noqa: F401
from tests.test_torch_sweep import _between_scores, _instances

cv2 = pytest.importorskip("cv2")
# the JAX Evaluator's GT masks from its numpy fill (tests/test_torch_eval.py)
pytestmark = pytest.mark.usefixtures("jax_numpy_fill")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def split(tmp_path_factory, jax_numpy_fill):
    """A train and a val split from the JAX package's synthetic generator
    and preprocessor (``tests/test_data_pipeline.py``'s recipe)."""
    from dis_yolo_tpu.data.preprocess import build_ground_truth_cache
    from dis_yolo_tpu.data.synthetic import generate_dataset
    root = str(tmp_path_factory.mktemp("solverdata"))
    generate_dataset(root, phases=("train", "val"), images_per_phase=3,
                     image_size=96, seed=1)
    for phase in ("train", "val"):
        build_ground_truth_cache(root, phase)
    return root


def _cfg(root, out, **kw):
    base = dict(dataset=root, output_dir=out, image_size=64, test_size=64,
                batch_size=2, pre_nms_top_k=64, compute_dtype="float32",
                max_iter=4, save_iter=2, summary_iter=1)
    base.update(kw)
    return DISYoloConfig(**base)


@pytest.fixture()
def out_dir(tmp_path):
    """An output directory removed after the test: a checkpoint of the
    full-width model takes hundreds of MB."""
    yield str(tmp_path / "out")
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def run4(split, tmp_path_factory):
    """A 4-step stage-1 Solver with validation every 2 steps (its
    directory removed after the module)."""
    out = str(tmp_path_factory.mktemp("run4"))
    cfg = _cfg(split, out)
    solver = Solver(cfg, evaluator=map_eval.Evaluator(cfg, "val"),
                    val_data=DefectValData(cfg, "val"), seed=0, device="cpu")
    solver.train()
    yield solver, out
    shutil.rmtree(out, ignore_errors=True)


def test_solver_writes_logs_checkpoints_and_history(run4):
    solver, out = run4
    ckpt_dir = os.path.join(out, "checkpoint")
    assert solver.state.step == 4 and solver.state.opt.count == 4
    assert sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")) \
        == ["step_00000002", "step_00000004"]
    best = ckpt.read_best(ckpt_dir)
    assert best["step"] in (2, 4) and 0.0 <= best["mAP"] <= 1.0
    with open(os.path.join(ckpt_dir, "train_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if r["kind"] == "train"]
    assert [r["step"] for r in train_rows] == [1, 2, 3, 4]
    for r in train_rows:
        assert np.isfinite(r["total_loss"]) and r["skipped_nonfinite"] == 0
    assert [r["step"] for r in rows if r["kind"] == "val"] == [2, 4]
    hist = np.load(os.path.join(out, "lossnp", "4map.npy"))
    assert hist.shape == (2, 9) and list(hist[:, 0]) == [2.0, 4.0]
    with open(os.path.join(ckpt_dir, "config.txt")) as f:
        assert "SAVE_ITER: 2" in f.read()
    assert solver.train_timer.calls == 4 and solver.load_timer.calls == 4
    # locked layers 1-52 unchanged from the seeded init
    init = api.init_model(solver.cfg, 0, device="cpu").state_dict()
    for k, v in solver.model.state_dict().items():
        if ts.layer_id(k) in solver.cfg.locked_layers:
            assert torch.equal(v, init[k]), k


def test_restore_auto_resumes_at_step_3(run4, out_dir):
    _, out = run4
    copy = out_dir
    shutil.copytree(out, copy, ignore=shutil.ignore_patterns("step_00000004"))
    cfg = run4[0].cfg.replace(output_dir=copy, max_iter=3)
    solver = Solver(cfg, restore="auto", seed=0, device="cpu")
    saved = torch.load(os.path.join(copy, "checkpoint", "step_00000002",
                                    "state"), weights_only=True)
    assert solver.state.step == 2 and solver.state.opt.count == 2
    for k, v in solver.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    for k in saved["mu"]:
        assert torch.equal(solver.state.opt.mu[k], saved["mu"][k])
        assert torch.equal(solver.state.opt.nu[k], saved["nu"][k])
    solver.train()                 # step 3 only
    assert solver.state.step == 3 and solver.state.opt.count == 3
    assert solver.best_step in (2, 4)          # best.json survives a resume


def test_train_equals_steps_by_hand(split, out_dir):
    cfg = _cfg(split, out_dir, max_iter=2, save_iter=100,
               summary_iter=100, locked_layers=())
    solver = Solver(cfg, seed=5, device="cpu")
    solver.train()
    model = api.init_model(cfg, 5, device="cpu")
    state = ts.init_train_state(model, device="cpu")
    step = ts.make_train_step(model, device="cpu")
    data = DefectTrainData(cfg, "train", seed=5)
    gen = torch.Generator().manual_seed(6)
    for _ in range(2):
        state, _ = step(state, data.get(), gen)
    for k, v in model.state_dict().items():
        assert torch.equal(solver.model.state_dict()[k], v), k
    for k in state.opt.mu:
        assert torch.equal(solver.state.opt.mu[k], state.opt.mu[k]), k
    assert solver.state.step == state.step == 2
    assert solver.rng.get_state().equal(gen.get_state())


@pytest.fixture(scope="module")
def variables():
    """Random JAX weights at 64 px, numpy leaves."""
    return as_numpy_tree(random_variables(JaxConfig(image_size=64), 3))


def test_validate_matches_jax_solver(split, tmp_path, variables):
    kw = dict(image_size=64, test_size=64, compute_dtype="float32",
              batch_size=2, pre_nms_top_k=64)
    probe = api.create_model(DISYoloConfig(**kw), device="cpu")
    probe.load_state_dict(state_dict_from_flax(variables))
    rng = np.random.RandomState(1)
    sizes = [(80, 60), (60, 90), (80, 60)]
    names = ["a0", "b1", "a2"]
    boxed = [letterbox_image(rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                             64) for h, w in sizes]
    arrays = (np.stack([b[0] for b in boxed]), names,
              np.stack([b[1] for b in boxed]))
    thresh = _between_scores(probe, arrays[0], calibrate_threshold(
        probe, torch.from_numpy(arrays[0]), probe.cfg, min_survivors=8))
    cfg = DISYoloConfig(**kw, obj_threshold=thresh, dataset=split,
                        output_dir=str(tmp_path / "port"))
    jcfg = JaxConfig(**kw, obj_threshold=thresh, dataset=split,
                     output_dir=str(tmp_path / "jax"))

    # ground truth: every second detection of the port's host sweep, and
    # one polygon per image that no detection matches
    probe = api.create_model(cfg, device="cpu")
    probe.load_state_dict(state_dict_from_flax(variables))
    host, _ = sweep.run_split(cfg, probe, *arrays[:3], device="cpu")
    gt = {}
    for det, (h, w) in zip(host, sizes):
        nm = det["imname"]
        gt[nm] = [{"imageid": nm, "classid": i["classid"], "difficult": 0,
                   "mask": i["mask"]} for i in _instances(det, h, w, cfg)[::2]]
        poly = [{"type": "out", "all_points_x": [0, 6, 6, 0],
                 "all_points_y": [h - 7, h - 7, h - 1, h - 1]}]
        gt[nm].append({"imageid": nm, "classid": 0, "difficult": 0,
                       "mask": rasterize.instance_mask(poly, h, w)})
    evs = []
    for ev in (map_eval.Evaluator(cfg, "val", annotations=[], index=[]),
               jax_map_eval.Evaluator(jcfg, "val", annotations=[], index=[])):
        ev.index, ev.gt_sizes, ev.gt_masks = names, dict(zip(names, sizes)), gt
        evs.append(ev)

    solver = Solver(cfg, evaluator=evs[0], val_data=object(), seed=0,
                    device="cpu")
    solver.model.load_state_dict(state_dict_from_flax(variables))
    # the JAX Solver with what its validate reads, without the optimizer
    # and loader its constructor also builds
    jsolver = JaxSolver.__new__(JaxSolver)
    jmodel = jax_api.create_model(jcfg)
    jsolver.__dict__.update(
        cfg=jcfg, mesh=None, evaluator=evs[1], val_data=object(),
        model=jmodel, predict_fn=jax_api.make_jitted_predict(jmodel),
        _paste_cache={}, state=jax_ts.TrainState(
            jax.tree.map(jnp.asarray, variables["params"]),
            jax.tree.map(jnp.asarray, variables["batch_stats"]), None,
            jnp.asarray(0)))
    solver._val_arrays = jsolver._val_arrays = arrays
    want = jsolver.validate()
    results = [solver.validate(), solver.validate(device_paste=True),
               solver.validate(device_score=True)]
    for res in [want] + results:
        for key in ("t_device_s", "t_post_s"):
            res.pop(key)
    assert 0.0 < want["mAP"] < 1.0
    for got in results:
        assert got == want


@pytest.fixture(scope="module")
def bridged64(variables):
    """The port's float32 model with the JAX weights (``stop_stage`` is
    set per case on this one instance)."""
    model = DISYolo(DISYoloConfig(image_size=64,
                                  compute_dtype="float32")).eval()
    model.load_state_dict(state_dict_from_flax(variables))
    return model


@pytest.mark.parametrize("stage", STOP_STAGES)
def test_stop_stage_matches_jax(stage, variables, bridged64):
    kw = dict(image_size=64, compute_dtype="float32")
    model = bridged64
    model.stop_stage = stage
    images = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    model.stop_stage = None
    want = JaxDISYolo(JaxConfig(**kw), stop_stage=stage).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images), train=False)
    assert len(got) == len(want) == 1
    w = np.asarray(want[0])
    assert got[0].shape == w.shape and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), w, rtol=1e-4,
                               atol=1e-4 * max(1.0, float(np.abs(w).max())))
    with pytest.raises(ValueError, match="stop_stage"):
        DISYolo(DISYoloConfig(**kw), stop_stage="mask")


def test_cli_train_two_steps_and_refusals(split, out_dir):
    out = out_dir
    argv = ["train", "--dataset", split, "--output-dir", out,
            "--image-size", "64", "--batch-size", "2", "--max-iter", "2",
            "--save-iter", "2", "--summary-iter", "1", "--no-validation",
            "--device", "cpu"]
    solver = cli.main(argv)
    assert solver.state.step == 2 and solver.device.type == "cpu"
    assert os.path.isdir(os.path.join(out, "checkpoint", "step_00000002"))
    # --data-parallel without torch.distributed.run: a mesh of one rank
    dp_argv = list(argv)
    dp_argv[dp_argv.index("--save-iter") + 1] = "4"     # no checkpoint
    solver = cli.main(dp_argv + ["--data-parallel"])
    assert solver.mesh.size == 1 and solver.state.step == 2
    # the device corpus in blocks of 2 (no checkpoint: save_iter 4)
    corpus_argv = [a if a != out else out + "_corpus" for a in argv]
    corpus_argv[corpus_argv.index("--save-iter") + 1] = "4"
    solver = cli.main(corpus_argv + ["--device-corpus",
                                     "--steps-per-dispatch", "2"])
    assert solver.cfg.device_corpus and solver.cfg.device_side_augs
    assert solver.state.step == 2 and solver.train_timer.calls == 1
    assert solver.device_corpus["images"].dtype == torch.uint8
    shutil.rmtree(out + "_corpus", ignore_errors=True)
    # infer, export and verify-gt are ported: infer stops at an image it
    # cannot read
    with pytest.raises(SystemExit, match="cannot read image"):
        cli.main(["infer", "--images", os.path.join(out, "missing.jpg"),
                  "--out", os.path.join(out, "infer"), "--image-size", "64",
                  "--device", "cpu"])


def test_blocks_equal_per_step_solver(split, out_dir, capsys):
    """``steps_per_dispatch=3`` with ``save_iter=4`` snaps to K=2 (and
    says so); 3 steps (a block of 2, a tail of 1) with device-side augs
    equal the default Solver's 3 blocks of one step: weights, moments,
    the step, both generators and the logged rows."""
    kw = dict(max_iter=3, save_iter=4, summary_iter=1, locked_layers=(),
              device_side_augs=True)
    runs = {}
    for k in (1, 3):
        out = os.path.join(out_dir, f"k{k}")
        solver = Solver(_cfg(split, out, steps_per_dispatch=k, **kw), seed=2,
                        device="cpu")
        solver.train()
        with open(os.path.join(out, "checkpoint", "train_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        runs[k] = solver, rows
    assert "steps_per_dispatch 3 -> 2 (snapped to a divisor of save_iter 4)" \
        in capsys.readouterr().out
    (one, rows1), (blk, rows3) = runs[1], runs[3]
    assert blk.train_timer.calls == 2 and one.train_timer.calls == 3
    for k, v in one.model.state_dict().items():
        assert torch.equal(blk.model.state_dict()[k], v), k
    for k in one.state.opt.mu:
        assert torch.equal(blk.state.opt.mu[k], one.state.opt.mu[k]), k
    assert blk.state.step == one.state.step == 3
    assert blk.rng.get_state().equal(one.rng.get_state())
    assert blk.aug_rng.get_state().equal(one.aug_rng.get_state())
    strip = lambda rows: [{k: v for k, v in r.items() if k != "ts"}
                          for r in rows]
    assert strip(rows3) == strip(rows1) and len(rows1) == 3


def test_corpus_solver_and_host_augs(split, out_dir):
    """The corpus Solver runs 2 steps (always in blocks); with
    ``device_side_augs`` both host loaders are built with
    ``host_augs=False``, and the batches equal ``build_example(...,
    host_augs=False)``'s."""
    cfg = _cfg(split, out_dir, max_iter=2, save_iter=4, device_corpus=True,
               device_side_augs=True)
    solver = Solver(cfg, seed=3, device="cpu")
    solver.train()
    assert solver.state.step == 2 and solver.train_timer.calls == 2
    assert solver.data.host_augs is False
    rows = open(os.path.join(out_dir, "checkpoint",
                             "train_metrics.jsonl")).read().splitlines()
    assert len(rows) == 2 and all(np.isfinite(json.loads(r)["total_loss"])
                                  for r in rows)

    wire = _cfg(split, out_dir, device_side_augs=True)
    got = Solver(wire, seed=4, device="cpu").data
    assert got.host_augs is False
    want = DefectTrainData(wire, "train", seed=4, host_augs=False)
    for _ in range(2):
        g, w = got.get(), want.get()
        assert all(np.array_equal(g[k], w[k]) for k in w)
    pool = Solver(wire.replace(loader_workers=2), seed=4, device="cpu").data
    assert pool.host_augs is False and pool.workers == 2

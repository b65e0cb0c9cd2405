"""The port's checkpoints (``train/checkpoint.py``, torch format) and its
TF1 and darknet weight bridges, on the CPU.

Checkpoints: save -> restore is bit-equal (parameters, BN statistics,
Adam's moments and counters, the step); the background save keeps at
most one snapshot queued and surfaces a failure at the next save;
pruning spares protected and in-flight steps; ``best.json``;
``restore_weights`` (the stage bridge).  Bridges: ``tf1_name_map``
equals the JAX package's for every conv layer; TF1 load/export and the
darknet reader, on the synthetic files ``tests/test_darknet.py`` and
``tests/test_tensorbundle.py`` build, equal the JAX package's results
carried through ``models/weights.state_dict_from_flax``.
"""

import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.train import checkpoint as jax_ckpt
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.models.weights import state_dict_from_flax
from dis_yolo_tpu_torch.train import checkpoint as ckpt
from dis_yolo_tpu_torch.train import train_step as ts
from dis_yolo_tpu_torch.train.synthetic import synthetic_batch
from tests.test_darknet import _shapes, _write_darknet
from tests.test_tensorbundle import write_bundle
from tests.test_torch_model import as_numpy_tree, random_variables

KW = dict(image_size=64, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trained():
    """A stage-1 model after two steps (moments and BN statistics moved)
    and its train state."""
    model = api.init_model(DISYoloConfig(**KW), seed=0, device="cpu")
    state = ts.init_train_state(model, device="cpu")
    step = ts.make_train_step(model, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = synthetic_batch(model.cfg, 2, 2, seed=0)
    for _ in range(2):
        state, _ = step(state, batch, gen)
    state.opt.total_notfinite = 3          # counters round-trip too
    state.opt.notfinite_count = 1
    return model, state


@pytest.fixture()
def ckpt_dir(tmp_path):
    """A checkpoint directory removed after the test: one checkpoint of
    the full-width model takes hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _fresh_state(cfg=None):
    model = api.init_model(cfg or DISYoloConfig(**KW), seed=9, device="cpu")
    return ts.init_train_state(model, device="cpu")


def _assert_state_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert list(a.opt.mu) == list(b.opt.mu) and a.opt.mu
    for k in a.opt.mu:
        assert torch.equal(a.opt.mu[k], b.opt.mu[k]), k
        assert torch.equal(a.opt.nu[k], b.opt.nu[k]), k
    assert (a.opt.count, a.opt.notfinite_count, a.opt.total_notfinite,
            a.step) == (b.opt.count, b.opt.notfinite_count,
                        b.opt.total_notfinite, b.step)


@pytest.mark.parametrize("background", [False, True])
def test_save_restore_bit_equal(trained, ckpt_dir, background):
    tmp_path = ckpt_dir
    _, state = trained
    assert state.step == 2 and state.opt.count == 2
    save = ckpt.save_checkpoint_background if background else \
        ckpt.save_checkpoint
    path = save(str(tmp_path), state, state.step)
    ckpt.wait_for_checkpoints()
    assert path.endswith("step_00000002")
    assert sorted(os.listdir(path)) == ["state", "weights"]
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    fresh = _fresh_state()
    ckpt.restore_checkpoint(path, fresh)
    _assert_state_equal(fresh, state)
    # the stage bridge: weights only
    other = _fresh_state(DISYoloConfig(**KW, locked_layers=()))
    ckpt.restore_weights(path, other.model)
    for k, v in state.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    assert other.opt.count == 0 and other.step == 0
    with pytest.raises(ValueError, match="restore_weights"):
        ckpt.restore_checkpoint(path, other)


def test_background_save_backpressure_and_failure(trained, ckpt_dir,
                                                   monkeypatch):
    tmp_path = ckpt_dir
    _, state = trained
    gate = threading.Event()
    started = []
    real = ckpt._save_snapshot

    def slow(ckpt_dir, step, snap, done):
        started.append(step)
        gate.wait(10)
        return real(ckpt_dir, step, snap, done)

    monkeypatch.setattr(ckpt, "_save_snapshot", slow)
    ckpt.save_checkpoint_background(str(tmp_path), state, 1)
    assert ckpt.pending_steps() == (1,)
    # stale step directories of an earlier run in the same place, one of
    # them the step in flight: pruning with the pending steps protected
    # spares it
    for s in (1, 7, 8):
        os.makedirs(tmp_path / f"step_{s:08d}")
    ckpt.prune_checkpoints(str(tmp_path), 1, protect=ckpt.pending_steps())
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000008"]
    # the next save waits for the one in flight: at most one queued
    second = threading.Thread(target=ckpt.save_checkpoint_background,
                              args=(str(tmp_path), state, 2))
    second.start()
    second.join(0.5)
    assert second.is_alive() and started == [1]
    gate.set()
    second.join(10)
    assert not second.is_alive()
    ckpt.wait_for_checkpoints()
    assert ckpt.pending_steps() == ()
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000002",
                                            "step_00000008"]

    def broken(ckpt_dir, step, snap, done):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_save_snapshot", broken)
    ckpt.save_checkpoint_background(str(tmp_path), state, 3)
    with pytest.raises(RuntimeError, match="step 3") as err:
        ckpt.save_checkpoint_background(str(tmp_path), state, 4)
    assert isinstance(err.value.__cause__, OSError)
    ckpt.wait_for_checkpoints()            # the failure was reported once
    monkeypatch.setattr(ckpt, "_save_snapshot", real)
    assert not os.path.exists(tmp_path / "step_00000003")


def test_prune_protect_pending_and_best(tmp_path):
    for s in (1, 2, 3, 4, 5):
        os.makedirs(tmp_path / f"step_{s:08d}")
    os.makedirs(tmp_path / "step_00000006.partial")     # not a checkpoint
    ckpt.prune_checkpoints(str(tmp_path), 0)              # keep all
    assert len(os.listdir(tmp_path)) == 6
    ckpt.prune_checkpoints(str(tmp_path), 2, protect=(1,) + (3,))
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000001", "step_00000003", "step_00000004", "step_00000005",
        "step_00000006.partial"]
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("step_00000005")
    assert ckpt.read_best(str(tmp_path)) is None
    assert ckpt.best_checkpoint(str(tmp_path)) is None
    ckpt.mark_best(str(tmp_path), 3, 0.25)
    assert ckpt.read_best(str(tmp_path)) == {"step": 3, "mAP": 0.25}
    assert ckpt.best_checkpoint(str(tmp_path)).endswith("step_00000003")
    ckpt.mark_best(str(tmp_path), 2, 0.5)
    assert ckpt.best_checkpoint(str(tmp_path)) is None   # pruned away


# ------------------------------------------------------------ the bridges

@pytest.fixture(scope="module")
def jax_variables():
    return as_numpy_tree(random_variables(JaxConfig(**KW), 1))


def test_tf1_name_map_matches_jax(jax_variables):
    sd = state_dict_from_flax(jax_variables)
    layers = ckpt._conv_layers(sd)
    assert len(layers) == 82
    for lid, name, has_bn in layers:
        assert has_bn == ("bn" in jax_variables["params"][name])
        assert ckpt.tf1_name_map(lid, has_bn) == jax_ckpt.tf1_name_map(lid,
                                                                       has_bn)


def _assert_sd_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_tf1_load_export_round_trip_matches_jax(jax_variables, tmp_path):
    rng = np.random.RandomState(2)
    sd = state_dict_from_flax(jax_variables)
    exported = ckpt.export_tf1_weights(sd)
    want = jax_ckpt.export_tf1_weights(jax_variables)
    assert sorted(exported) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(exported[name], want[name])
    # a TF1 V2 bundle with the reference's names: a few backbone, head and
    # mask-subnet layers (small ones: the bundle reader's crc32c is numpy)
    kept = ("convolutional1/", "convolutional2/", "convolutional3/",
            "convolutional59/", "convolutional75/", "convolutional76/",
            "convolutional82/")
    tensors = [(name, rng.rand(*arr.shape).astype(np.float32), 0)
               for name, arr in sorted(want.items())
               if any(k in name for k in kept)]
    prefix = str(tmp_path / "yolov3_3class_coco.ckpt")
    write_bundle(prefix, tensors, entries_per_block=16)
    values = ckpt.convert_tf1_checkpoint(prefix)
    jvalues = jax_ckpt.convert_tf1_checkpoint(prefix)
    assert sorted(values) == sorted(jvalues)
    for fn, jfn in ((ckpt.stage1_restore, jax_ckpt.stage1_restore),
                    (ckpt.load_tf1_weights, jax_ckpt.load_tf1_weights)):
        got = fn(sd, values)
        _assert_sd_equal(got, state_dict_from_flax(
            as_numpy_tree(jfn(jax_variables, jvalues))))
    back = ckpt.export_tf1_weights(ckpt.load_tf1_weights(sd, values))
    for name, arr, _ in tensors:
        np.testing.assert_array_equal(back[name], arr)
    with pytest.raises(KeyError):
        ckpt.load_tf1_weights(sd, values, ignore_missing=False)
    with pytest.raises(FileNotFoundError, match="TensorBundle"):
        ckpt.convert_tf1_checkpoint(str(tmp_path / "missing.ckpt"))


@pytest.mark.parametrize("source_classes", [80])
def test_read_darknet_weights_matches_jax(ckpt_dir, source_classes):
    tmp_path = ckpt_dir
    jcfg = JaxConfig()
    shapes = _shapes(jcfg)
    path = str(tmp_path / "yolov3.weights")
    expect = _write_darknet(path, shapes, source_classes,
                            np.random.RandomState(source_classes))
    with torch.device("meta"):
        from dis_yolo_tpu_torch.models.dis_yolo import DISYolo
        sd = DISYolo(DISYoloConfig()).state_dict()
    got = ckpt.read_darknet_weights(path, sd, source_classes=source_classes)
    want = jax_ckpt.read_darknet_weights(path, shapes,
                                         source_classes=source_classes)
    assert sorted(got) == sorted(want) == sorted(expect)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(got[name], expect[name])
    if source_classes == 80:
        with pytest.raises(ValueError, match="unread floats|truncated"):
            ckpt.read_darknet_weights(path, sd, source_classes=None)


def test_darknet_into_stage1_matches_jax(ckpt_dir, jax_variables):
    """darknet file with this model's 3 classes (no crop) ->
    stage1_restore, port against JAX, at 64 px."""
    tmp_path = ckpt_dir
    jcfg = JaxConfig(**KW)
    shapes = jax.eval_shape(lambda: jax_variables)
    path = str(tmp_path / "yolov3.weights")
    _write_darknet(path, shapes, 3, np.random.RandomState(5))
    sd = state_dict_from_flax(jax_variables)
    values = ckpt.read_darknet_weights(path, sd, source_classes=3)
    merged = ckpt.stage1_restore(sd, values)
    want = state_dict_from_flax(as_numpy_tree(jax_ckpt.stage1_restore(
        jax_variables, jax_ckpt.read_darknet_weights(path, shapes, 3))))
    _assert_sd_equal(merged, want)
    assert torch.equal(merged["convolutional78.conv.weight"],
                       sd["convolutional78.conv.weight"])
    assert jcfg.image_size == 64

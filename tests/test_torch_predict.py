"""Port parity of the whole serving slice: decode -> NMS -> degenerate-box
drop -> mask assembly (-> paste), ``dis_yolo_tpu_torch`` vs the numpy
oracle of the reference chain and vs the JAX package, on the CPU.

The JAX package's CPU predict assembles with the gather path (sigmoid(0)
= 0.5 outside the box); the port follows the Pallas kernel (exact 0
outside), so JAX masks are taken from ``assemble_masks_batch_pallas(...,
interpret=True)`` on JAX's own detections, times validity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu.ops import paste as jax_paste
from dis_yolo_tpu.ops.pallas_assembly import assemble_masks_batch_pallas
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.models.weights import state_dict_from_flax
from dis_yolo_tpu_torch.ops import paste
from tests.np_reference_chain import np_reference_predict
from tests.test_torch_model import random_variables


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def compare_with_oracle(dets, masks, ora_boxes, ora_masks, atol=2e-5):
    """Padded [B,D,6]/[B,D,S,S] vs the oracle's ragged per-image lists."""
    for i in range(dets.shape[0]):
        valid = dets[i, :, 5] > 0.0
        got_rows, want_rows = dets[i][valid], ora_boxes[i]
        assert got_rows.shape == want_rows.shape, f"image {i} keep set"
        np.testing.assert_array_equal(got_rows[:, 4], want_rows[:, 4])
        np.testing.assert_allclose(got_rows[:, :4], want_rows[:, :4],
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(got_rows[:, 5], want_rows[:, 5],
                                   rtol=0, atol=atol)
        if want_rows.shape[0]:
            # the oracle sigmoids every pixel; the port writes 0 outside
            want = np.asarray(ora_masks[i])
            got = masks[i][valid]
            inside = got != 0
            np.testing.assert_allclose(got[inside], want[inside], rtol=0,
                                       atol=atol)
            assert np.all(want[~inside] == 0.5)


def jax_reference(jcfg, raws, windows, thresh):
    """JAX dets, and masks from the Pallas kernel (interpret mode)."""
    dets, _ = jax.jit(lambda r, w: jax_api.predict_from_outputs(
        jcfg, r, w, thresh))([jnp.asarray(r) for r in raws],
                             jnp.asarray(windows))
    valid = np.asarray(dets[..., 5] > 0)
    masks = assemble_masks_batch_pallas(jnp.asarray(raws[3]), dets[..., :4],
                                        jcfg.k_map, interpret=True)
    return np.asarray(dets), np.asarray(masks) * valid[..., None, None]


def assert_slice_matches_jax(dets, masks, jdets, jmasks, atol=2e-5):
    np.testing.assert_array_equal(dets[..., 5] > 0, jdets[..., 5] > 0)
    np.testing.assert_array_equal(dets[..., 4], jdets[..., 4])
    np.testing.assert_allclose(dets, jdets, rtol=0, atol=atol)
    np.testing.assert_array_equal(masks == 0, jmasks == 0)
    np.testing.assert_allclose(masks, jmasks, rtol=0, atol=atol)


def test_predict_from_outputs_full_576_shapes():
    """Full production shapes (grids 72/36/18, S=288, B=2, two windows):
    the port's post-forward chain vs the numpy oracle and vs JAX."""
    cfg, jcfg = DISYoloConfig(), JaxConfig()
    rng = np.random.RandomState(0)
    raws = [rng.randn(2, g, g, 3, 8).astype(np.float32) for g in (72, 36, 18)]
    raws.append(rng.randn(2, 288, 288, 9).astype(np.float32))
    windows = np.array([[0.0, 0.0, 1.0, 1.0], [0.1, 0.05, 0.9, 0.95]],
                       np.float32)
    dets, masks = api.predict_from_outputs(cfg, raws, windows, device="cpu")
    dets, masks = dets.numpy(), masks.numpy()
    assert dets.shape == (2, 30, 6) and masks.shape == (2, 30, 288, 288)
    assert (dets[..., 5] > 0).sum() >= 10

    ora_boxes, ora_masks = np_reference_predict(
        raws, windows, cfg.anchors_array(), cfg.obj_threshold,
        cfg.iou_threshold, cfg.max_detection, cfg.num_class, cfg.k_map)
    compare_with_oracle(dets, masks, ora_boxes, ora_masks)
    assert_slice_matches_jax(dets, masks,
                             *jax_reference(jcfg, raws, windows,
                                            cfg.obj_threshold))


@pytest.fixture(scope="module")
def small_slice():
    """The 64 px model with numpy-drawn weights on both sides, JAX's raw
    outputs and its reference predict for one batch."""
    kw = dict(image_size=64, pre_nms_top_k=64, compute_dtype="float32")
    jcfg = JaxConfig(**kw)
    variables = jax.tree.map(np.asarray, random_variables(jcfg, 3))
    rng = np.random.RandomState(4)
    images = rng.rand(2, 64, 64, 3).astype(np.float32)
    windows = np.array([[0.0, 0.0, 1.0, 1.0], [0.0, 0.1, 1.0, 0.9]],
                       np.float32)
    thresh = 1e-3      # random weights: push real detections through
    jraws = [np.asarray(r) for r in jax.jit(
        lambda v, x: jax_api.create_model(jcfg).apply(v, x, train=False))(
            variables, images)]
    return (kw, state_dict_from_flax(variables), images, windows, thresh,
            jax_reference(jcfg, jraws, windows, thresh))


@pytest.mark.parametrize("use_pallas_nms", [False, True])
def test_predict_end_to_end_and_paste(small_slice, use_pallas_nms):
    """``predict`` through the 64 px model with bridged weights vs JAX
    (forward, decode, NMS, assembly), then ``paste_masks_batch`` on the
    result vs the JAX paste.  On the CPU ``use_pallas_nms`` keeps the
    fixpoint engine, as in JAX."""
    kw, state_dict, images, windows, thresh, (jdets, jmasks) = small_slice
    model = api.create_model(DISYoloConfig(use_pallas_nms=use_pallas_nms,
                                           **kw), device="cpu")
    model.load_state_dict(state_dict)
    dets, masks = api.predict(model, images, windows, thresh, device="cpu")
    dets, masks = dets.numpy(), masks.numpy()
    assert (dets[..., 5] > 0).sum() >= 10
    assert_slice_matches_jax(dets, masks, jdets, jmasks)

    got = paste.paste_masks_batch(torch.from_numpy(masks),
                                  torch.from_numpy(dets), 96, 80, 64)
    want = jax_paste.paste_masks_batch(jnp.asarray(masks), jnp.asarray(dets),
                                       96, 80, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].any()

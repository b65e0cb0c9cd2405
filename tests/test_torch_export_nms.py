"""Port parity of what the serving export traces, on the CPU: the eager
gather assembly route (``use_pallas_assembly=False``) and NMS's control
flow (the fixpoint ``while_loop`` and the shortfall ``cond``), eager and
through ``torch.export``, against the JAX package.  Tolerances are those
of ``tests/test_torch_predict.py`` (atol 2e-5 at float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu.ops import nms as jax_nms
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.models.weights import state_dict_from_flax
from dis_yolo_tpu_torch.ops import nms
from tests.test_torch_model import random_variables
from tests.test_torch_ops import T, _nms_cases, _pad_batch, assert_dets_match

KW = dict(image_size=64, test_size=64, pre_nms_top_k=64,
          compute_dtype="float32")
THRESH = 1e-3           # random weights: push real detections through


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_eager_gather_route_matches_jax():
    """``use_pallas_assembly=False`` in eager predict equals JAX's jnp
    route: the sigmoid of every pixel (0.5 outside the box) on valid
    rows, 0 on padding rows; detections and in-box masks as with K1."""
    jcfg, cfg = JaxConfig(**KW), DISYoloConfig(**KW)
    variables = jax.tree.map(np.asarray, random_variables(jcfg, 3))
    model = api.create_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    rng = np.random.RandomState(4)
    images = rng.rand(2, 64, 64, 3).astype(np.float32)
    windows = np.array([[0.0, 0.0, 1.0, 1.0], [0.0, 0.1, 1.0, 0.9]],
                       np.float32)
    raws = api.forward(model, images, device="cpu")
    got = api.predict_from_outputs(cfg.replace(use_pallas_assembly=False),
                                   raws, windows, THRESH, device="cpu")
    k1 = api.predict_from_outputs(cfg, raws, windows, THRESH, device="cpu")
    want = jax.jit(lambda r, w: jax_api.predict_from_outputs(
        jcfg, r, w, THRESH, pallas=False))(
            [jnp.asarray(r.numpy()) for r in raws], jnp.asarray(windows))
    dets, masks = (x.numpy() for x in got)
    assert_dets_match(dets, np.asarray(want[0]))
    np.testing.assert_allclose(masks, np.asarray(want[1]), rtol=0, atol=2e-5)
    assert torch.equal(got[0], k1[0])
    valid = dets[..., 5] > 0
    assert valid.sum() >= 20
    inside = k1[1].numpy() != 0
    # K1's sigmoid is 1/(1+exp(-x)), torch.sigmoid's rounds apart by ulps
    np.testing.assert_allclose(masks[inside], k1[1].numpy()[inside],
                               rtol=0, atol=1e-6)
    assert np.all(masks[valid][~inside[valid]] == 0.5)
    assert np.all(masks[~valid] == 0)


class _Filter(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    def forward(self, conf, prob, coord, windows):
        return nms.filter_candidates(conf, prob, coord, windows, self.cfg,
                                     self.cfg.obj_threshold)


@pytest.mark.parametrize("case", ["random", "fallback16", "ladder_ties"])
def test_exported_nms_matches_jax(case):
    """NMS alone through ``torch.export`` (the fixpoint ``while_loop`` and
    the shortfall ``cond`` as graph operators), exported and eager,
    against JAX's ``filter_detections_single``: "fallback16" takes the
    full pass (image 0's shortlist falls short), "random" does not,
    "ladder_ties" sweeps long suppression chains."""
    name, kw, group = next(c for c in _nms_cases() if c[0] == case)
    cfg, jcfg = DISYoloConfig(**kw), JaxConfig(**kw)
    args = tuple(T(a) for a in _pad_batch(group))
    _, shortfall = nms._shortlist_nms(*args, cfg, cfg.obj_threshold)
    assert bool(shortfall.any()) == (case == "fallback16")
    with torch.no_grad():
        ep = torch.export.export(_Filter(cfg), args)
    graph = str(ep.graph)
    assert "while_loop" in graph and "cond" in graph
    got = ep.module()(*args).numpy()
    np.testing.assert_array_equal(got, nms.filter_candidates(
        *args, cfg, cfg.obj_threshold).numpy())
    single = jax.jit(lambda c, p, x, w: jax_nms.filter_detections_single(
        c, p, x, w, jcfg, jcfg.obj_threshold))
    for i in range(len(group)):
        want = np.asarray(single(*(jnp.asarray(a[i].numpy()) for a in args)))
        assert_dets_match(got[i], want)
    assert (got[..., 5] > 0).sum() > 0

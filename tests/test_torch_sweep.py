"""Port parity of the evaluation sweep (``eval/sweep.run_split``) against
the JAX package's, on the CPU.

Part one mirrors ``tests/test_sweep.py``: ``api.predict`` is stubbed on
both sides with the same deterministic head, on 5 images in 2
original-size groups with interleaved names, a tail batch (B=2) and a
repeated sweep on one ``paste_cache``.  The three routes (host,
``device_paste``, ``device_score``) of the port and of the JAX package
must give the same ``evaluate_detections`` and mIoU results, exactly,
and the same fetched arrays (packed masks, IoU rows, confusion totals).

Part two is one real sweep at 64 px, float32, with the JAX package's
weights carried over through ``models/weights.py``, on 3 images in 2
sizes: the port's three routes against the JAX package's host route,
same AP, mAP, recall and precision.  Its ground truth is every second
detection of the port's host sweep (random weights score about 0 AP on
any other ground truth), plus one polygon per image that no detection
matches.  The two forwards agree to about 1e-6 (``test_torch_model``):
the detection threshold is set between two candidate scores, away from
any (``_between_scores``), the raw masks are held within 1e-4 of JAX's
inside their boxes and the metrics are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dis_yolo_tpu.data.augment as jax_augment
import dis_yolo_tpu.data.rasterize as jax_rasterize
from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.eval import map_eval as jax_map_eval
from dis_yolo_tpu.eval import sweep as jax_sweep
from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data import rasterize
from dis_yolo_tpu_torch.data.val_data import letterbox_image
from dis_yolo_tpu_torch.eval import map_eval, sweep
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.models.weights import state_dict_from_flax
from dis_yolo_tpu_torch.ops.decode import decode_all
from dis_yolo_tpu_torch.utils.runtime import calibrate_threshold
from tests.test_torch_model import as_numpy_tree, random_variables

S = 16  # score-map size of the stubbed head


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_fake_predict(model, variables, imgs, wins, obj_thresh=None):
    """``tests/test_sweep.py``'s stand-in for JAX's ``api.predict``: one
    detection per image whose class and score derive from a per-image tag
    in pixel [0,0,0], so any batch or row misalignment changes the
    metrics."""
    b, d = imgs.shape[0], 4
    tag = imgs[:, 0, 0, 0]
    cls = jnp.mod(jnp.floor(tag * 100.0), 3.0)
    row0 = jnp.stack([jnp.full((b,), 0.1), jnp.full((b,), 0.1),
                      jnp.full((b,), 0.9), jnp.full((b,), 0.9),
                      cls, 0.3 + tag], axis=-1)
    boxes = jnp.zeros((b, d, 6)).at[:, 0].set(row0)
    masks = jnp.zeros((b, d, S, S)).at[:, 0].set(
        0.9 * (0.6 + tag)[:, None, None])
    return boxes, masks


def _fake_predict(model, imgs, wins, obj_thresh=None, device=None):
    """The same head for the port, in torch float32."""
    b, d = imgs.shape[0], 4
    tag = imgs[:, 0, 0, 0]
    cls = torch.remainder(torch.floor(tag * 100.0), 3.0)
    row0 = torch.stack([torch.full((b,), 0.1), torch.full((b,), 0.1),
                        torch.full((b,), 0.9), torch.full((b,), 0.9),
                        cls, 0.3 + tag], dim=-1)
    boxes = torch.zeros((b, d, 6))
    boxes[:, 0] = row0
    masks = torch.zeros((b, d, S, S))
    masks[:, 0] = 0.9 * (0.6 + tag)[:, None, None]
    return boxes, masks


def _set_gt(ev, names, sizes, masks):
    ev.index = list(names)
    ev.gt_sizes = dict(zip(names, sizes))
    ev.gt_masks, ev.gt_semantic = {}, {}
    for nm, objs in zip(names, masks):
        ev.gt_masks[nm] = [{"imageid": nm, "classid": c, "difficult": 0,
                            "mask": m} for c, m in objs]
        sem = np.zeros(ev.gt_sizes[nm], np.uint8)
        for c, m in objs:
            sem[m] = c + 1
        ev.gt_semantic[nm] = sem


@pytest.fixture()
def split():
    """``tests/test_sweep.py``'s split: 5 images in 2 original-size groups,
    names interleaved, per-image GT of mixed classes; one Evaluator per
    package over the same GT."""
    rng = np.random.RandomState(0)
    kw = dict(test_size=32, batch_size=2)
    sizes = [(24, 28), (20, 28), (24, 28), (24, 28), (20, 28)]
    names = [f"im{i}" for i in range(5)]
    gts = []
    for i, (h, w) in enumerate(sizes):
        objs = []
        for g in range(1 + i % 3):
            if g == 0:
                m = np.ones((h, w), bool)      # the stub's box overlaps it
            else:
                m = rng.rand(h, w) > 0.45
                m[0, 0] = True
            objs.append(((g + i) % 3, m))
        gts.append(objs)
    ev = map_eval.Evaluator(DISYoloConfig(**kw), "test", with_semantic=True,
                            annotations=[], index=[])
    jev = jax_map_eval.Evaluator(JaxConfig(**kw), "test", with_semantic=True,
                                 annotations=[], index=[])
    for e in (ev, jev):
        _set_gt(e, names, sizes, gts)
    images = np.zeros((5, 32, 32, 3), np.float32)
    images[:, 0, 0, 0] = (np.arange(5) + 1) * 0.05      # the per-image tag
    windows = np.tile(np.asarray([0., 0., 1., 1.], np.float32), (5, 1))
    return ev, jev, images, names, windows


def _score(ev, detdata, route):
    """(metrics without the wall time, mIoU) of one sweep."""
    if route == "device_score":
        res = ev.evaluate_detections(detdata)
        miou = ev.miou_from_confusions({d["imname"]: d["confusion"]
                                        for d in detdata})
    else:
        res = ev.evaluate_detections(detdata, collect_semantic=True)
        miou = ev.miou(res.pop("semantic_maps"))
    assert res.pop("t_post_s") >= 0.0
    return res, miou


ROUTES = {"host": {}, "device_paste": {"device_paste": True},
          "device_score": {"device_score": True}}


def _route_kwargs(ev, route):
    kw = dict(ROUTES[route])
    if route != "host":
        kw["gt_sizes"] = ev.gt_sizes
    if route == "device_score":
        kw.update(gt_records=ev.gt_masks, gt_semantic=ev.gt_semantic)
    return kw


def test_routes_match_jax_and_each_other(split, monkeypatch):
    ev, jev, images, names, windows = split
    monkeypatch.setattr(jax_api, "predict", _jax_fake_predict)
    monkeypatch.setattr(api, "predict", _fake_predict)
    results, fetched = {}, {}
    for route in ROUTES:
        want, _ = jax_sweep.run_split(jev.cfg, None, {}, images, names,
                                      windows, **_route_kwargs(jev, route))
        timing = {}
        got, t_pred = sweep.run_split(ev.cfg, None, images, names, windows,
                                      timing=timing, device="cpu",
                                      **_route_kwargs(ev, route))
        assert t_pred >= 0.0 and timing["fetch_s"] >= 0.0
        assert [d["imname"] for d in got] == names
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                if key != "imname":
                    np.testing.assert_array_equal(g[key], np.asarray(w[key]),
                                                  err_msg=f"{route} {key}")
        results[route] = _score(ev, got, route)
        assert results[route] == _score(jev, want, route), route
        fetched[route] = got
    first = results["host"]
    assert first[0]["mAP"] > 0.0 and 0.0 < first[1]["miou"] < 1.0
    for route, res in results.items():
        assert res == first, route
    assert all(d["full_masks_packed"].dtype == np.uint8
               for d in fetched["device_paste"])


def test_repeated_sweeps_reuse_the_cache(split, monkeypatch):
    """A second sweep on the same ``paste_cache`` uploads no ground truth
    and no images again, builds no new functions and gives the same
    results; a different split is never served the cached images."""
    ev, _, images, names, windows = split
    monkeypatch.setattr(api, "predict", _fake_predict)
    for route in ("device_paste", "device_score"):
        cache = {}
        kw = dict(_route_kwargs(ev, route), paste_cache=cache, device="cpu")
        first, _ = sweep.run_split(ev.cfg, None, images, names, windows, **kw)
        held = dict(cache)
        if route == "device_score":
            assert {k[0] for k in cache if isinstance(k, tuple)} >= {
                "__gt__", "__gtsem__", "score"}
        again, _ = sweep.run_split(ev.cfg, None, images, names, windows, **kw)
        assert set(cache) == set(held)
        assert all(cache[k] is v for k, v in held.items())
        assert _score(ev, again, route) == _score(ev, first, route)
    # the same values in a new array: the resident copy is replaced
    other = images.copy()
    other[:, 0, 0, 0] = other[::-1, 0, 0, 0]
    swapped, _ = sweep.run_split(ev.cfg, None, other, names, windows,
                                 **_route_kwargs(ev, "device_score"),
                                 paste_cache=cache, device="cpu")
    assert cache["__imgs__"][0] is other
    assert swapped[0]["boxes"][0, 5] == pytest.approx(0.3 + 0.25)


def test_host_route_predict_fn_and_refusals(split, monkeypatch):
    ev, _, images, names, windows = split
    calls = []

    def predict_fn(imgs, wins):
        calls.append(imgs.shape[0])
        return _fake_predict(None, imgs, wins)

    predict_fn._warmed = True
    got, _ = sweep.run_split(ev.cfg, None, images, names, windows,
                             predict_fn=predict_fn, device="cpu")
    assert calls == [2, 2, 2]          # no warm-up call; the tail is padded
    assert [d["imname"] for d in got] == names
    assert got[4]["masks"].shape == (4, S, S)
    with pytest.raises(NotImplementedError, match="A.7"):
        sweep.run_split(ev.cfg, None, images, names, windows, mesh=object(),
                        device="cpu")
    # asked for the card (the default) with none there: every route raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for route in ROUTES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep.run_split(ev.cfg, None, images, names, windows,
                            predict_fn=predict_fn, **_route_kwargs(ev, route))


# ------------------------------------------------------------- real sweep

def test_real_sweep_64px_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_augment, "cv2", None)
    monkeypatch.setattr(jax_rasterize, "_HAS_CV2", False)
    monkeypatch.setattr(jax_rasterize, "_native_available", lambda: False)
    kw = dict(image_size=64, test_size=64, compute_dtype="float32",
              batch_size=2, pre_nms_top_k=64)
    jcfg = JaxConfig(**kw)
    variables = as_numpy_tree(random_variables(jcfg, 3))
    model = api.create_model(DISYoloConfig(**kw), device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))

    rng = np.random.RandomState(1)
    sizes = [(80, 60), (60, 90), (80, 60)]
    names = ["a0", "b1", "a2"]
    boxed = [letterbox_image(rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                             64) for h, w in sizes]
    images = np.stack([b[0] for b in boxed])
    windows = np.stack([b[1] for b in boxed])
    thresh = _between_scores(model, images, calibrate_threshold(
        model, torch.from_numpy(images), model.cfg, min_survivors=8))
    cfg = model.cfg.replace(obj_threshold=thresh)
    model = api.create_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    jcfg = JaxConfig(**kw, obj_threshold=thresh)

    # ground truth: every second detection of the port's host sweep, and
    # one polygon per image that no detection matches
    ev = map_eval.Evaluator(cfg, "test", annotations=[], index=[])
    ev.index, ev.gt_sizes = list(names), dict(zip(names, sizes))
    ev.gt_masks = {nm: [] for nm in names}
    host, _ = sweep.run_split(cfg, model, images, names, windows,
                              device="cpu")
    n_dets = 0
    for det, (h, w) in zip(host, sizes):
        nm = det["imname"]
        for inst in _instances(det, h, w, cfg)[::2]:
            ev.gt_masks[nm].append({"imageid": nm, "classid": inst["classid"],
                                    "difficult": 0, "mask": inst["mask"]})
        n_dets += len(_instances(det, h, w, cfg))
        poly = [{"type": "out", "all_points_x": [0, 6, 6, 0],
                 "all_points_y": [h - 7, h - 7, h - 1, h - 1]}]
        ev.gt_masks[nm].append({"imageid": nm, "classid": 0, "difficult": 0,
                                "mask": rasterize.instance_mask(poly, h, w)})
    assert n_dets >= 6
    jev = jax_map_eval.Evaluator(jcfg, "test", annotations=[], index=[])
    jev.index, jev.gt_sizes, jev.gt_masks = ev.index, ev.gt_sizes, ev.gt_masks

    jdet, _ = jax_sweep.run_split(jcfg, jax_api.create_model(jcfg),
                                  jax.tree.map(jnp.asarray, variables),
                                  images, names, windows)
    want = jev.evaluate_detections(jdet)
    want.pop("t_post_s")
    assert 0.0 < want["mAP"] < 1.0
    for route in ROUTES:
        kw_r = dict(ROUTES[route])
        if route != "host":
            kw_r["gt_sizes"] = ev.gt_sizes
        if route == "device_score":
            kw_r["gt_records"] = ev.gt_masks
        got, _ = sweep.run_split(cfg, model, images, names, windows,
                                 device="cpu", **kw_r)
        res = ev.evaluate_detections(got)
        res.pop("t_post_s")
        assert res == want, route
    jmasks = [d["masks"] for d in jdet]
    for det, jm, (h, w) in zip(host, jmasks, sizes):
        # JAX's CPU predict assembles by gather: sigmoid(0) = 0.5 outside
        # the box, where the port's kernel route writes 0
        inside = det["masks"] != 0
        assert inside.any()
        np.testing.assert_allclose(det["masks"][inside], jm[inside], rtol=0,
                                   atol=1e-4)
        assert np.isin(jm[~inside], (0.0, 0.5)).all()
        for inst, g in zip(_instances(det, h, w, cfg)[::2],
                           ev.gt_masks[det["imname"]]):
            assert (inst["mask"] == g["mask"]).all()


def _between_scores(model, images, calibrated):
    """A threshold midway between the calibrated one and the next higher
    candidate score.  The calibrated threshold is itself a candidate's
    score, a tie by construction: the strict ``score > threshold`` then
    keeps that candidate on whichever side computed it 1 ulp higher."""
    raws = api.forward(model, images, device="cpu")
    scores = np.concatenate([
        (torch.sigmoid(p.conf_logit[..., 0])
         * torch.softmax(p.class_logit, -1).amax(-1)).reshape(-1).numpy()
        for p in decode_all(raws[:3], model.cfg)])
    above = scores[scores > calibrated].min()
    assert above - calibrated > 1e-5       # far beyond the forward's 1e-6
    return float((calibrated + above) / 2)


def _instances(det, h, w, cfg):
    from dis_yolo_tpu_torch.eval.postprocess import detections_to_original
    return detections_to_original(det["boxes"], det["masks"], h, w,
                                  cfg.test_size)

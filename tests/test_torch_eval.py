"""Port parity of the evaluation path's host and scoring code against the
JAX package, on the CPU: ``ops/paste``'s bit packing, mask IoU and
confusion totals; ``data/augment.resize_bilinear``; ``data/rasterize``;
``data/val_data``; ``eval/voc_eval``; ``eval/postprocess``;
``eval/map_eval.Evaluator``.

Everything is compared for exact equality, with two stated exceptions:
``Evaluator``'s ``t_post_s`` is a wall time (checked present and >= 0),
and ``DefectValData``'s images against the JAX package's, which resizes
with ``cv2.resize`` where OpenCV imports while the port keeps the numpy
formula: within 1e-6 after the /255 (the two resizes differ by at most
2.9e-5 on the 0-255 inputs of ``test_resize_bilinear_equals_jax_numpy_route``;
``tests/test_native.py`` bounds the cv2 route at 1e-4).
Where the JAX function has a cv2 route (``resize_bilinear`` and what
calls it, the polygon fill), the JAX side runs with OpenCV and the
native fill switched off, as on the card's machine.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dis_yolo_tpu.data.augment as jax_augment
import dis_yolo_tpu.data.rasterize as jax_rasterize
from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.data import val_data as jax_val_data
from dis_yolo_tpu.eval import map_eval as jax_map_eval
from dis_yolo_tpu.eval import postprocess as jax_post
from dis_yolo_tpu.eval import voc_eval as jax_voc
from dis_yolo_tpu.ops import paste as jax_paste
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data import augment, rasterize, val_data
from dis_yolo_tpu_torch.eval import map_eval, postprocess, voc_eval
from dis_yolo_tpu_torch.ops import paste


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def jax_numpy_only(monkeypatch):
    """The JAX package without OpenCV and without its native fill."""
    monkeypatch.setattr(jax_augment, "cv2", None)
    monkeypatch.setattr(jax_rasterize, "_HAS_CV2", False)
    monkeypatch.setattr(jax_rasterize, "_native_available", lambda: False)


# ------------------------------------------------------- ops/paste scoring

@pytest.mark.parametrize("width", [1, 7, 8, 13, 45])
def test_pack_unpack_mask_bits_match_numpy_and_jax(width):
    m = np.random.RandomState(width).rand(2, 3, 5, width) > 0.5
    got = paste.pack_mask_bits(torch.from_numpy(m))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.packbits(m, axis=-1))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_paste.pack_mask_bits(jnp.asarray(m))))
    back = paste.unpack_mask_bits(got, width)
    assert back.dtype == torch.bool
    np.testing.assert_array_equal(back.numpy(), m)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax_paste.unpack_mask_bits(jnp.asarray(got.numpy()), width)))


def _iou_case(seed, b, h, w, d, g):
    rng = np.random.RandomState(seed)
    det = rng.rand(b, d, h, w) > rng.uniform(0.2, 0.8, (b, d, 1, 1))
    det[:, 1] = False                      # an empty detection: IoU 0 row
    gt = rng.rand(b, g, h, w) > 0.6
    gt[:, :, 0, 0] = True                  # no zero-area GT (rasterization)
    return det, np.packbits(gt, axis=-1), gt.sum(axis=(2, 3)).astype(
        np.float32)


@pytest.mark.parametrize("h,w", [(29, 45), (96, 96)])
def test_mask_iou_bit_identical_to_jax_and_popcount(h, w):
    """[B,D,G] IoU: bit-identical to JAX's ``mask_iou_batch`` and to the
    host popcount; at 96 x 96 the intersections reach the thousands,
    where a bfloat16 product would round them."""
    det, gt_p, gt_a = _iou_case(h, 2, h, w, 6, 4)
    got = paste.mask_iou_batch(torch.from_numpy(det), torch.from_numpy(gt_p),
                               torch.from_numpy(gt_a)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 6, 4)
    np.testing.assert_array_equal(got, np.asarray(jax_paste.mask_iou_batch(
        jnp.asarray(det), jnp.asarray(gt_p), jnp.asarray(gt_a))))
    for i in range(2):
        single = paste.mask_iou_single(torch.from_numpy(det[i]),
                                       torch.from_numpy(gt_p[i]),
                                       torch.from_numpy(gt_a[i])).numpy()
        np.testing.assert_array_equal(single, got[i])
        for k in range(6):
            want = voc_eval.packed_overlaps(np.packbits(det[i, k], axis=-1),
                                            gt_p[i], gt_a[i].astype(np.int64))
            np.testing.assert_array_equal(got[i, k], want)
    assert (got > 0).any() and (got[:, 1] == 0).all()


@pytest.mark.parametrize("shape", [(41, 37), (2, 96, 96)])
def test_semantic_confusion_exact(shape):
    n = 4
    rng = np.random.RandomState(len(shape))
    t = rng.randint(0, n, shape).astype(np.uint8)
    p = rng.randint(0, n, shape).astype(np.uint8)
    got = paste.semantic_confusion(torch.from_numpy(p), torch.from_numpy(t),
                                   n).numpy()
    assert got.dtype == np.int32 and got.shape == shape[:-2] + (n, n)
    want = np.stack([np.bincount(
        ti.astype(np.int64).ravel() * n + pi.astype(np.int64).ravel(),
        minlength=n * n).reshape(n, n)
        for ti, pi in zip(t.reshape((-1,) + shape[-2:]),
                          p.reshape((-1,) + shape[-2:]))]).reshape(got.shape)
    np.testing.assert_array_equal(got, want)
    jfn = jax_paste.semantic_confusion
    for ti, pi, gi in zip(t.reshape((-1,) + shape[-2:]),
                          p.reshape((-1,) + shape[-2:]),
                          got.reshape(-1, n, n)):
        np.testing.assert_array_equal(
            gi, np.asarray(jfn(jnp.asarray(pi), jnp.asarray(ti), n)))


# ------------------------------------------------- data/augment, rasterize

@pytest.mark.parametrize("shape,w,h", [((37, 23, 3), 61, 41),
                                       ((50, 40, 3), 100, 75),
                                       ((20, 31), 9, 13), ((5, 7, 3), 5, 7)])
def test_resize_bilinear_equals_jax_numpy_route(shape, w, h, monkeypatch):
    src = (np.random.RandomState(w).rand(*shape) * 255).astype(np.float32)
    got = augment.resize_bilinear(src, w, h)
    has_cv2 = jax_augment.cv2 is not None
    cv2_route = jax_augment.resize_bilinear(src, w, h)
    monkeypatch.setattr(jax_augment, "cv2", None)
    want = jax_augment.resize_bilinear(src, w, h)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if has_cv2:
        # the cv2 route (where OpenCV imports) is close, not equal:
        # measured at most 2.9e-5 on these 0-255 inputs, within the 1e-4
        # that tests/test_native.py allows the cv2 route
        np.testing.assert_allclose(got, cv2_route, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape,w,h", [((12, 9), 1, 11), ((12, 9), 7, 1),
                                       ((12, 9, 3), 1, 11)])
def test_resize_bilinear_to_one_pixel_keeps_rank(shape, w, h, monkeypatch):
    """A one-pixel-wide (or -high) target, as a one-pixel-wide box's paste
    asks for: the port keeps the input's rank, as ``cv2.resize`` does; the
    JAX package's numpy formula squeezes that axis away (the paste of such
    a box then fails to broadcast there), with the same values."""
    src = np.random.RandomState(w + h).rand(*shape).astype(np.float32)
    got = augment.resize_bilinear(src, w, h)
    assert got.shape == (h, w) + shape[2:]
    if jax_augment.cv2 is not None:
        assert jax_augment.resize_bilinear(src, w, h).shape == got.shape
    monkeypatch.setattr(jax_augment, "cv2", None)
    want = jax_augment.resize_bilinear(src, w, h)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def _random_polygon(rng, cx, cy, r, n):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = r * rng.uniform(0.4, 1.0, n)
    return (np.round(cx + rad * np.cos(ang)).astype(int).tolist(),
            np.round(cy + rad * np.sin(ang)).astype(int).tolist())


def _instances(rng, h, w, count):
    """Random instances: 'out' polygons, some with an 'in' hole, some
    running off the image."""
    out = []
    for _ in range(count):
        cx, cy = rng.uniform(-5, w + 5), rng.uniform(-5, h + 5)
        r = rng.uniform(4, min(h, w) / 2)
        polys = []
        for kind, scale in (("out", 1.0), ("in", 0.45), ("out", 0.2)):
            if kind != "out" and rng.rand() < 0.3:
                continue
            xs, ys = _random_polygon(rng, cx, cy, r * scale,
                                     int(rng.randint(3, 9)))
            polys.append({"type": kind, "all_points_x": xs,
                          "all_points_y": ys})
        out.append(polys)
    return out


@pytest.mark.parametrize("h,w", [(48, 48), (37, 61), (70, 29)])
def test_rasterize_bit_equal_to_jax_numpy_engine(h, w):
    rng = np.random.RandomState(h * w)
    insts = _instances(rng, h, w, 8)
    for polys in insts:
        got = rasterize.instance_mask(polys, h, w)
        np.testing.assert_array_equal(
            got, jax_rasterize.instance_mask(polys, h, w, engine="numpy"))
        assert rasterize.mask_to_box(got) == jax_rasterize.mask_to_box(got)
        p = polys[0]
        np.testing.assert_array_equal(
            rasterize.fill_polygon_scanline(np.asarray(p["all_points_x"]),
                                            np.asarray(p["all_points_y"]),
                                            h, w),
            jax_rasterize.fill_polygon_scanline(
                np.asarray(p["all_points_x"]), np.asarray(p["all_points_y"]),
                h, w))
    stack = rasterize.instance_masks(insts, h, w, 10)
    np.testing.assert_array_equal(stack, jax_rasterize.instance_masks(
        insts, h, w, 10, engine="numpy"))
    assert stack.any() and not stack[8:].any()
    # a hole's rim stays on: a square with a hole
    sq = [{"type": "out", "all_points_x": [2, 20, 20, 2],
           "all_points_y": [2, 2, 20, 20]},
          {"type": "in", "all_points_x": [8, 14, 14, 8],
           "all_points_y": [8, 8, 14, 14]}]
    m = rasterize.instance_mask(sq, h, w)
    assert m[8, 8] and m[14, 14] and not m[11, 11]
    np.testing.assert_array_equal(
        m, jax_rasterize.instance_mask(sq, h, w, engine="numpy"))
    assert rasterize.mask_to_box(np.zeros((h, w), bool)) is None


# --------------------------------------------------------- data/val_data

@pytest.mark.parametrize("ih,iw,size", [(97, 61, 64), (61, 97, 64),
                                        (33, 33, 64), (101, 75, 96)])
def test_letterbox_image_equals_jax_numpy_route(ih, iw, size, jax_numpy_only):
    img = np.random.RandomState(ih).randint(0, 256, (ih, iw, 3)).astype(
        np.uint8)
    got = val_data.letterbox_image(img, size)
    want = jax_val_data.letterbox_image(img, size)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype == np.float32
        np.testing.assert_array_equal(g, w_)


def test_defect_val_data_matches_jax(tmp_path):
    """On a split the JAX package's generator and preprocessor build:
    the same names and windows; images within 1e-6 of the JAX package's
    (its cv2 resize against the port's formula, see the module's
    docstring)."""
    pytest.importorskip("cv2")
    from dis_yolo_tpu.data.preprocess import build_ground_truth_cache
    from dis_yolo_tpu.data.synthetic import generate_dataset

    root = str(tmp_path)
    generate_dataset(root, phases=("val",), images_per_phase=3,
                     image_size=96, seed=5)
    build_ground_truth_cache(root, "val")
    kw = dict(dataset=root, test_size=64)
    got_i, got_n, got_w = val_data.DefectValData(
        DISYoloConfig(**kw), "val").get()
    want_i, want_n, want_w = jax_val_data.DefectValData(
        JaxConfig(**kw), "val").get()
    assert got_n == want_n and len(got_n) >= 1
    np.testing.assert_array_equal(got_w, want_w)
    assert got_i.shape == want_i.shape and got_i.dtype == np.float32
    np.testing.assert_allclose(got_i, want_i, rtol=0, atol=1e-6)


def test_defect_val_data_refuses_without_cv2(tmp_path, monkeypatch):
    """No JPEG decoder, no silent fallback: ``get`` raises."""
    import builtins

    cache = tmp_path / "val" / "cache"
    cache.mkdir(parents=True)
    with open(cache / "ground_truth_cache.pkl", "wb") as f:
        pickle.dump([{"filename": "a.jpg", "regions": {"0": {}},
                      "size": [8, 8]}], f)
    (cache / "val.txt").write_text("a\n")
    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    data = val_data.DefectValData(DISYoloConfig(dataset=str(tmp_path)), "val")
    with pytest.raises(RuntimeError, match="OpenCV"):
        data.get()


# ------------------------------------------------------------ eval/voc_eval

def _voc_case(seed, packed):
    rng = np.random.RandomState(seed)
    h, w = 23, 37
    gt, dets = {}, []
    names = ["a", "b", "c", "d"]
    for img in names:
        gt[img] = [{"classid": int(rng.randint(0, 2)),
                    "difficult": int(rng.rand() < 0.15),
                    "mask": rng.rand(h, w) > 0.55} for _ in range(3)]
        for d in range(5):
            m = gt[img][d % 3]["mask"] ^ (rng.rand(h, w) > 0.7 + 0.05 * d)
            det = {"imageid": img, "score": float(rng.rand())}
            if packed:
                det["mask_packed"] = np.packbits(m, axis=-1)
            else:
                det["mask"] = m
            dets.append(det)
    return gt, dets, names


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voc_eval_equals_jax(seed, packed):
    gt, dets, names = _voc_case(seed, packed)
    for c in (0, 1, 2):
        got = voc_eval.voc_eval(dets, gt, names, c)
        want = jax_voc.voc_eval(_voc_case(seed, packed)[1],
                                _voc_case(seed, packed)[0], names, c)
        assert got == want, c
    rec = np.sort(np.random.RandomState(seed).rand(7))
    prec = np.random.RandomState(seed + 9).rand(7)
    for m07 in (False, True):
        assert voc_eval.voc_ap(rec, prec, m07) == jax_voc.voc_ap(rec, prec,
                                                                 m07)
    a = np.stack([o["mask"] for o in gt["a"]], -1).astype(float)
    np.testing.assert_array_equal(voc_eval.compute_overlaps_masks(a, a[..., :2]),
                                  jax_voc.compute_overlaps_masks(a, a[..., :2]))


# ---------------------------------------------------------- eval/postprocess

def _dets_and_masks(rng, d, s):
    """Padded detections with valid rows, padding rows (score 0), a box
    degenerate in original pixels and one degenerate at score-map size.
    The others are at least 3 pixels wide at 64 px: the JAX package's
    numpy resize cannot paste a one-pixel-wide box (see
    ``test_resize_bilinear_to_one_pixel_keeps_rank``)."""
    y1 = rng.uniform(0.0, 0.7, d)
    x1 = rng.uniform(0.0, 0.7, d)
    dets = np.stack([y1, x1, y1 + rng.uniform(0.05, 0.3, d),
                     x1 + rng.uniform(0.05, 0.3, d),
                     rng.randint(0, 3, d), rng.uniform(0.3, 1.0, d)],
                    1).astype(np.float32)
    dets[-2:] = 0.0                                   # padding rows
    dets[0, 2] = dets[0, 0] + 1e-4                    # degenerate in pixels
    # empty at score-map size: both edges round to the same column
    dets[1, 1] = (np.around(dets[1, 1] * s) + 0.1) / s
    dets[1, 3] = dets[1, 1] + 0.3 / s
    masks = rng.rand(d, s, s).astype(np.float32)
    return dets, masks


@pytest.mark.parametrize("ih,iw", [(64, 64), (80, 52), (45, 90)])
def test_detections_to_original_equals_jax(ih, iw, jax_numpy_only):
    rng = np.random.RandomState(ih + iw)
    dets, masks = _dets_and_masks(rng, 10, 32)
    merged_got = np.zeros((ih, iw), np.uint8)
    merged_want = np.zeros((ih, iw), np.uint8)
    got = postprocess.detections_to_original(dets, masks, ih, iw, 64,
                                             merged_got)
    want = jax_post.detections_to_original(dets, masks, ih, iw, 64,
                                           merged_want)
    assert len(got) == len(want) and 0 < len(got) < 8
    for g, w_ in zip(got, want):
        assert (g["classid"], g["score"], g["box"]) == \
            (w_["classid"], w_["score"], w_["box"])
        np.testing.assert_array_equal(g["mask"], w_["mask"])
    np.testing.assert_array_equal(merged_got, merged_want)
    assert merged_got.any()
    for box in ((0.1, 0.2, 0.5, 0.6), (0.0, 0.0, 1.0, 1.0), (0.5, 0.5, 0.5, 0.9)):
        assert postprocess.correct_yolo_box(*box, ih, iw, 64, 64) == \
            jax_post.correct_yolo_box(*box, ih, iw, 64, 64)


# --------------------------------------------------------- eval/map_eval

def _annotations(rng, n, sizes):
    anns, index = [], []
    classes = ("crack", "spall", "rebar")
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        regions = {}
        for j, polys in enumerate(_instances(rng, h, w, 2 + i % 3)):
            regions[str(j)] = {"region_attributes": classes[(i + j) % 3],
                               "shape_attributes": polys}
        anns.append({"filename": f"im{i}.jpg", "regions": regions,
                     "size": [h, w]})
        index.append(f"im{i}")
    return anns, index


def _detdata(rng, ev, kind, s=32, net=64, d=8):
    """A detection sweep in one of the four entry kinds of
    ``evaluate_detections``, with hits on the ground truth."""
    out = []
    for stem in ev.index:
        h, w = ev.gt_sizes[stem]
        dets, masks = _dets_and_masks(rng, d, s)
        # GT boxes (at least 3 pixels wide: see _dets_and_masks) in
        # letterboxed coordinates, with masks that fill them
        boxes = [(rasterize.mask_to_box(o["mask"]), o["classid"])
                 for o in ev.gt_masks[stem]]
        boxes = [(b, c) for b, c in boxes if min(b[2] - b[0], b[3] - b[1]) >= 3]
        nw = net if net / w < net / h else (w * net) // h
        nh = net if net / w >= net / h else (h * net) // w
        ox, oy = (net - nw) // 2, (net - nh) // 2
        for k, ((x1, y1, x2, y2), cls) in enumerate(boxes[:d - 4]):
            dets[k + 2] = [(oy + y1 * nh / h) / net, (ox + x1 * nw / w) / net,
                           (oy + y2 * nh / h) / net, (ox + x2 * nw / w) / net,
                           cls, 0.95 - 0.05 * k]
            masks[k + 2] = 0.9
        entry = {"imname": stem, "boxes": dets}
        if kind == "masks":
            entry["masks"] = masks
        else:
            full = np.zeros((d, h, w), bool)
            valid = np.zeros((d,), bool)
            for k in range(d):
                inst = postprocess.detections_to_original(
                    dets[k:k + 1], masks[k:k + 1], h, w, net)
                if inst:
                    full[k], valid[k] = inst[0]["mask"], True
            sem = np.zeros((h, w), np.uint8)
            for k in range(d):
                if valid[k]:
                    sem[full[k]] = int(dets[k, 4]) + 1
            entry.update(valid=valid)
            if kind == "full_masks":
                entry.update(full_masks=full, semantic=sem)
            elif kind == "full_masks_packed":
                entry.update(full_masks_packed=np.packbits(full, axis=-1),
                             semantic=sem)
            else:
                gtm = np.stack([o["mask"] for o in ev.gt_masks[stem]])
                entry["iou"] = paste.mask_iou_single(
                    torch.from_numpy(full),
                    torch.from_numpy(np.packbits(gtm, axis=-1)),
                    torch.from_numpy(gtm.sum(axis=(1, 2)).astype(np.float32))
                ).numpy()
                n = ev.cfg.num_class + 1
                entry["confusion"] = paste.semantic_confusion(
                    torch.from_numpy(sem),
                    torch.from_numpy(ev.gt_semantic[stem]), n).numpy()
        out.append(entry)
    return out


def _assert_results_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        if key == "t_post_s":
            assert got[key] >= 0.0
        elif key == "semantic_maps":
            assert set(got[key]) == set(want[key])
            for stem in want[key]:
                np.testing.assert_array_equal(got[key][stem], want[key][stem])
        else:
            assert got[key] == want[key], key


@pytest.fixture(scope="module")
def evaluators():
    """The port's and the JAX package's Evaluator over the same passed
    annotations (odd sizes, holes, polygons off the image), with the JAX
    polygon fill on its numpy engine."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_augment, "cv2", None)
    mp.setattr(jax_rasterize, "_HAS_CV2", False)
    mp.setattr(jax_rasterize, "_native_available", lambda: False)
    anns, index = _annotations(np.random.RandomState(3), 5,
                               [(48, 64), (61, 37)])
    kw = dict(test_size=64)
    ev = map_eval.Evaluator(DISYoloConfig(**kw), "test", with_semantic=True,
                            annotations=anns, index=index)
    jev = jax_map_eval.Evaluator(JaxConfig(**kw), "test", with_semantic=True,
                                 annotations=anns, index=index)
    yield ev, jev
    mp.undo()


def test_evaluator_ground_truth_equals_jax(evaluators):
    ev, jev = evaluators
    assert ev.index == jev.index and ev.gt_sizes == jev.gt_sizes
    for stem in jev.index:
        assert len(ev.gt_masks[stem]) == len(jev.gt_masks[stem]) > 0
        for g, w_ in zip(ev.gt_masks[stem], jev.gt_masks[stem]):
            assert {k: v for k, v in g.items() if k != "mask"} == \
                {k: v for k, v in w_.items() if k != "mask"}
            np.testing.assert_array_equal(g["mask"], w_["mask"])
        np.testing.assert_array_equal(ev.gt_semantic[stem],
                                      jev.gt_semantic[stem])


@pytest.mark.parametrize("kind", ["masks", "full_masks", "full_masks_packed",
                                  "iou"])
def test_evaluate_detections_equals_jax(evaluators, kind, jax_numpy_only):
    """Every key of the result dict (and the mIoU, from the semantic maps
    or from the confusion totals) equals JAX's on the same detections."""
    ev, jev = evaluators
    detdata = _detdata(np.random.RandomState(7), ev, kind)
    collect = kind != "iou"
    got = ev.evaluate_detections(detdata, collect_semantic=collect)
    want = jev.evaluate_detections(detdata, collect_semantic=collect)
    _assert_results_equal(got, want)
    assert 0.0 < got["mAP"] < 1.0
    if collect:
        assert ev.miou(got["semantic_maps"]) == jev.miou(want["semantic_maps"])
    else:
        confs = {d["imname"]: d["confusion"] for d in detdata}
        assert ev.miou_from_confusions(confs) == \
            jev.miou_from_confusions(confs)
        with pytest.raises(ValueError, match="collect_semantic"):
            ev.evaluate_detections([{k: v for k, v in d.items()
                                     if k != "confusion"} for d in detdata],
                                   collect_semantic=True)
    if kind == "full_masks_packed":    # all entry kinds score alike
        for other in ("masks", "iou"):
            res = ev.evaluate_detections(
                _detdata(np.random.RandomState(7), ev, other))
            assert res["AP"] == got["AP"] and res["recall"] == got["recall"]


def test_evaluator_from_disk_cache_and_rebuild(tmp_path, jax_numpy_only):
    """Ground truth read from ``cache/ground_truth_cache.pkl`` and
    ``<phase>.txt``; the rasterized cache written, read back, and
    rebuilt when unreadable; equal to JAX's throughout."""
    anns, index = _annotations(np.random.RandomState(4), 3, [(40, 56)])
    anns.append({"filename": "empty.jpg", "regions": {}, "size": [8, 8]})
    cache = tmp_path / "val" / "cache"
    cache.mkdir(parents=True)
    with open(cache / "ground_truth_cache.pkl", "wb") as f:
        pickle.dump(anns, f)
    (cache / "val.txt").write_text("".join(s + "\n" for s in index))
    kw = dict(dataset=str(tmp_path), test_size=64)
    jev = jax_map_eval.Evaluator(JaxConfig(**kw), "val", with_semantic=True,
                                 use_cache=False)
    rast = cache / "gt_rasterized_val.pkl"
    for attempt in ("build", "load", "rebuild"):
        if attempt == "rebuild":
            rast.write_bytes(b"garbage")
        ev = map_eval.Evaluator(DISYoloConfig(**kw), "val",
                                with_semantic=True)
        assert rast.is_file() and os.path.getsize(rast) > 100
        assert ev.index == jev.index == index
        for stem in index:
            np.testing.assert_array_equal(ev.gt_semantic[stem],
                                          jev.gt_semantic[stem])
            assert [o["classid"] for o in ev.gt_masks[stem]] == \
                [o["classid"] for o in jev.gt_masks[stem]]

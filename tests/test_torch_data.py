"""Port parity of the training loader (``data/augment.py``,
``data/dataset.py``, ``data/image_io.py``, ``native/``) against the JAX
package's, on the CPU, with OpenCV present on the JAX side.

The JAX package calls OpenCV for the uint8 resize, the HLS round trip,
the blur and JPEG decoding; the port computes the same in numpy (the
card's machine has no OpenCV).  Bounds held here:

  * ``place_and_pad`` of uint8 images, over the placements
    ``sample_scale_crop`` draws: at most 1 LSB, on at most 0.1% of the
    pixels (the share is counted and asserted); float masks rounded at
    0.5: bit-equal;
  * ``change_light``: L and S bit-exact, H within 1 on at most 0.01% of
    the pixels (exact .5 ties of OpenCV's scalar tail); the whole
    augmentation within 1 LSB on at most 0.01%;
  * blur: within 1 LSB; salt and pepper, the placement draws, anchor
    assignment and box placement: exact;
  * ``build_example`` and three batches of ``DefectTrainData`` and
    ``ParallelTrainData(workers=0)``: grids, boxes and packed masks
    exact, images within the ``place_and_pad`` bound, and the
    ``RandomState`` in the same state afterwards.

``ParallelTrainData(workers=2)`` (spawn) must stop within 10 s; the test
measures that with a thread join, so it cannot hang the suite.
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest

import dis_yolo_tpu.data.augment as jax_augment
import dis_yolo_tpu.data.dataset as jax_dataset
import dis_yolo_tpu.data.rasterize as jax_rasterize
from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu_torch import native
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data import augment, dataset, image_io, rasterize

from tests.test_torch_eval import jax_numpy_fill  # noqa: F401

cv2 = pytest.importorskip("cv2")
# the JAX loader's masks from its numpy fill (tests/test_torch_eval.py)
pytestmark = pytest.mark.usefixtures("jax_numpy_fill")

# uint8 pixels: at most 1 LSB off, on at most this share of the pixels
PIXEL_SHARE = 1e-3
HUE_SHARE = 1e-4


def _u8_diff(got, want):
    """(max |diff|, share of differing values) of two uint8 arrays."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return int(d.max()) if d.size else 0, float((d > 0).mean())


def _image(rng, h, w):
    """A concrete-like texture with a darkened band (not white noise)."""
    base = rng.normal(140, 25, (h, w, 3))
    base[h // 3:h // 2] *= 0.4
    return base.clip(0, 255).astype(np.uint8)


# ------------------------------------------------------------- augment

@pytest.mark.parametrize("src", [(720, 960), (96, 64), (60, 90)])
def test_place_and_pad_u8_within_one_lsb(src):
    rng = np.random.RandomState(src[0])
    img = _image(rng, *src)
    diffs = total = 0
    for seed in range(24):
        net = (576, 96, 64)[seed % 3]
        r_jax, r_port = (np.random.RandomState(seed) for _ in range(2))
        want_p = jax_augment.sample_scale_crop(r_jax, src[1], src[0], net, net)
        got_p = augment.sample_scale_crop(r_port, src[1], src[0], net, net)
        assert got_p == want_p
        _, nw, nh, dx, dy = got_p
        want = jax_augment.place_and_pad(img, nw, nh, dx, dy, net, net, 127)
        got = augment.place_and_pad(img, nw, nh, dx, dy, net, net, 127)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        worst, share = _u8_diff(got, want)
        assert worst <= 1
        diffs += share * got.size
        total += got.size
        mask = np.zeros(src, np.float32)
        mask[src[0] // 4:src[0] // 2, src[1] // 3:src[1] // 2 + 3] = 1
        mk_w = jax_augment.place_and_pad(mask, nw, nh, dx, dy, net, net, 0.0)
        mk_g = augment.place_and_pad(mask, nw, nh, dx, dy, net, net, 0.0)
        np.testing.assert_array_equal(np.around(mk_g[..., 0]).astype(bool),
                                      np.around(mk_w[..., 0]).astype(bool))
    assert diffs / total <= PIXEL_SHARE, diffs / total


@pytest.mark.parametrize("src,dst", [((64, 80), (40, 32)), ((96, 64), (32, 48)),
                                     ((37, 23), (61, 41)), ((50, 40), (17, 9))])
def test_resize_u8_matches_cv2(src, dst):
    """Including an exact 2x downscale, which OpenCV runs as INTER_AREA."""
    img = _image(np.random.RandomState(3), *src)
    for x in (img, img[..., 0]):
        want = cv2.resize(x, dst, interpolation=cv2.INTER_LINEAR)
        got = augment.resize_bilinear(x, *dst)
        assert got.shape == want.shape
        worst, share = _u8_diff(got, want)
        assert worst <= 1 and share <= PIXEL_SHARE


def test_change_light_hls_round_trip():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (96, 96, 3)).astype(np.uint8)
    want = cv2.cvtColor(img, cv2.COLOR_RGB2HLS)
    h, l, s = augment.rgb_to_hls_u8(img)
    np.testing.assert_array_equal(l, want[..., 1])
    np.testing.assert_array_equal(s, want[..., 2])
    worst, share = _u8_diff(h, want[..., 0])
    assert worst <= 1 and share <= HUE_SHARE
    hls = np.stack([rng.randint(0, 180, (64, 64)), rng.randint(0, 256, (64, 64)),
                    rng.randint(0, 256, (64, 64))], -1).astype(np.uint8)
    np.testing.assert_array_equal(augment.hls_to_rgb_u8(*hls.transpose(2, 0, 1)),
                                  cv2.cvtColor(hls, cv2.COLOR_HLS2RGB))
    diffs = total = 0
    for seed in range(8):
        x = _image(np.random.RandomState(seed), 64, 72)
        r_jax, r_port = (np.random.RandomState(seed) for _ in range(2))
        worst, share = _u8_diff(augment.change_light(x.copy(), r_port),
                                jax_augment.change_light(x.copy(), r_jax))
        assert worst <= 1
        diffs += share * x.size
        total += x.size
        assert r_port.get_state()[2] == r_jax.get_state()[2]
    assert diffs / total <= HUE_SHARE


def test_blur_and_salt_pepper():
    for seed in range(12):
        x = _image(np.random.RandomState(seed), 48, 56)
        r_jax, r_port = (np.random.RandomState(seed) for _ in range(2))
        worst, _ = _u8_diff(augment.linear_motion_blur(x, r_port),
                            jax_augment.linear_motion_blur(x, r_jax))
        assert worst <= 1
        np.testing.assert_array_equal(
            augment.add_salt_pepper_noise(x.copy(), r_port),
            jax_augment.add_salt_pepper_noise(x.copy(), r_jax))
        for bnl in (1, 2, 3, 4):
            worst, _ = _u8_diff(augment.apply_photometric(x.copy(), bnl, r_port),
                                jax_augment.apply_photometric(x.copy(), bnl, r_jax))
            assert worst <= 1
        assert r_port.get_state()[2] == r_jax.get_state()[2]
        np.testing.assert_array_equal(r_port.get_state()[1], r_jax.get_state()[1])


# ---------------------------------------------------- labels and grids

def _labels(rng, n, h, w):
    """Seeded VIA-style labels: 1-4 polygons per image over 3 classes,
    one of them with a hole."""
    labels = []
    for _ in range(n):
        polys, names = [], []
        for j in range(rng.randint(1, 5)):
            cx, cy = rng.randint(8, w - 8), rng.randint(8, h - 8)
            r = rng.randint(3, min(h, w) // 3)
            ang = np.sort(rng.uniform(0, 2 * np.pi, rng.randint(3, 9)))
            xs = np.clip(cx + r * np.cos(ang), 0, w - 1).astype(int).tolist()
            ys = np.clip(cy + r * np.sin(ang), 0, h - 1).astype(int).tolist()
            shape = [{"type": "out", "all_points_x": xs, "all_points_y": ys}]
            if j == 0 and r > 6:
                shape.append({"type": "in",
                              "all_points_x": [cx - 2, cx + 2, cx + 2, cx - 2],
                              "all_points_y": [cy - 2, cy - 2, cy + 2, cy + 2]})
            polys.append(shape)
            names.append(("crack", "spall", "rebar")[rng.randint(3)])
        labels.append({"polygons": polys, "class_names": names})
    return labels


def test_assign_anchors_and_boxes_to_net_exact():
    rng = np.random.RandomState(4)
    for size in (64, 96, 576):
        kw = dict(image_size=size)
        boxes = rng.uniform(0, size, (12, 4)).astype(np.float32)
        boxes[:, 2:] = rng.uniform(4, size / 2, (12, 2))
        boxes[3] = boxes[2]                       # an occupied cell
        cls = rng.randint(0, 3, 12)
        for g, w in zip(dataset.assign_anchors(boxes, cls, DISYoloConfig(**kw)),
                        jax_dataset.assign_anchors(boxes, cls, JaxConfig(**kw))):
            np.testing.assert_array_equal(g, w)
        x1y1 = rng.uniform(0, 60, (5, 2))
        px = np.concatenate([x1y1, x1y1 + rng.uniform(2, 40, (5, 2))], 1)
        args = (px.astype(np.float32), cls[:5], 20, 70, 52, -3, 9, 80, 60, size)
        for g, w in zip(dataset.boxes_to_net(*args),
                        jax_dataset.boxes_to_net(*args)):
            np.testing.assert_array_equal(g, w)
        for seed in range(20):
            r_jax, r_port = (np.random.RandomState(seed) for _ in range(2))
            assert (dataset.sample_placement(r_port, 80, 60, size, px)
                    == jax_dataset.sample_placement(r_jax, 80, 60, size, px))


def _check_example(got, want):
    np.testing.assert_array_equal(got["true_box"], want["true_box"])
    for g, w in zip(got["grids"], want["grids"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got["masks_packed"], want["masks_packed"])
    worst, share = _u8_diff(got["image_u8"], want["image_u8"])
    assert worst <= 1 and share <= PIXEL_SHARE, (worst, share)


@pytest.mark.parametrize("size", [64, 96])
def test_build_example_matches_jax(size, tmp_path, monkeypatch):
    rng = np.random.RandomState(size)
    labels = _labels(rng, 6, 72, 96)
    images = {}
    for i, lab in enumerate(labels):
        lab["imname"] = str(tmp_path / f"{i}.jpg")
        images[lab["imname"]] = _image(rng, 72, 96)
    kw = dict(image_size=size, max_box_per_image=3)
    for i, lab in enumerate(labels):
        r_jax, r_port = (np.random.RandomState(i) for _ in range(2))
        want = jax_dataset.build_example(JaxConfig(**kw), lab, r_jax, True,
                                         load_image=images.__getitem__)
        for engine in rasterize.ENGINES:
            monkeypatch.setattr(dataset, "FILL_ENGINE", engine)
            r_port = np.random.RandomState(i)
            got = dataset.build_example(DISYoloConfig(**kw), lab, r_port, True,
                                        load_image=images.__getitem__)
            _check_example(got, want)
            assert r_port.get_state()[2] == r_jax.get_state()[2]
            np.testing.assert_array_equal(r_port.get_state()[1],
                                          r_jax.get_state()[1])


# ---------------------------------------------- images, fills, loaders

def test_ppm_reader_matches_cv2(tmp_path):
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(7, 5), (64, 96), (33, 1)]):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        path = str(tmp_path / f"{i}.jpg")
        image_io.write_ppm(path, img)
        got = image_io.read_image(path)
        want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(got, want)
    with open(tmp_path / "c.ppm", "wb") as f:
        f.write(b"P6\n# a comment\n2 1\n255\n" + bytes(range(6)))
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "c.ppm")),
                                  np.arange(6, dtype=np.uint8).reshape(1, 2, 3))
    # a real JPEG goes to OpenCV
    jpg = str(tmp_path / "real.jpg")
    cv2.imwrite(jpg, img[..., ::-1])
    np.testing.assert_array_equal(image_io.read_image(jpg),
                                  jax_dataset._read_image(jpg))


def test_native_fill_matches_numpy_and_jax():
    rng = np.random.RandomState(1)
    for _ in range(12):
        k = rng.randint(3, 10)
        xs = rng.uniform(-3, 60, k)
        ys = rng.uniform(-3, 50, k)
        want = rasterize.fill_polygon(xs, ys, 48, 56, "numpy")
        np.testing.assert_array_equal(
            rasterize.fill_polygon(xs, ys, 48, 56, "native"), want)
        np.testing.assert_array_equal(
            jax_rasterize._fill(xs, ys, 48, 56, engine="numpy"), want)
    labels = _labels(rng, 4, 40, 52)
    for lab in labels:
        want = jax_rasterize.instance_masks(lab["polygons"], 40, 52, 5)
        for engine in rasterize.ENGINES:
            np.testing.assert_array_equal(
                rasterize.instance_masks(lab["polygons"], 40, 52, 5, engine),
                want)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory, jax_numpy_fill):
    """``tests/test_data_pipeline.py``'s recipe: the JAX package's
    synthetic generator and preprocessor (JPEG images, real contours)."""
    from dis_yolo_tpu.data.preprocess import build_ground_truth_cache
    from dis_yolo_tpu.data.synthetic import generate_dataset
    root = str(tmp_path_factory.mktemp("synthdata"))
    generate_dataset(root, phases=("train",), images_per_phase=5,
                     image_size=96, seed=0)
    build_ground_truth_cache(root, "train")
    return root


def _check_batch(got, want):
    assert set(got) == set(want)
    for key in want:
        if key == "images":
            worst, share = _u8_diff(got[key], want[key])
            assert worst <= 1 and share <= PIXEL_SHARE, (worst, share)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("parallel", [False, True])
def test_loader_batches_match_jax(synth_root, parallel):
    kw = dict(dataset=synth_root, image_size=64, batch_size=2)
    labels = dataset.load_labels(DISYoloConfig(**kw), "train")
    assert labels == jax_dataset.load_labels(JaxConfig(**kw), "train")
    if parallel:
        got = dataset.ParallelTrainData(DISYoloConfig(**kw), seed=3, workers=0)
        want = jax_dataset.ParallelTrainData(JaxConfig(**kw), seed=3, workers=0)
    else:
        got = dataset.DefectTrainData(DISYoloConfig(**kw), seed=3)
        want = jax_dataset.DefectTrainData(JaxConfig(**kw), seed=3)
    for _ in range(3):
        _check_batch(got.get(), want.get())
    assert got.epoch == want.epoch == 2
    np.testing.assert_array_equal(got.order, want.order)


def _timed_stop(loader):
    """Seconds ``loader.stop()`` took, measured from another thread so a
    hang fails the test instead of blocking the suite."""
    t0 = time.monotonic()
    done = threading.Thread(target=loader.stop, daemon=True)
    done.start()
    done.join(10.0)
    assert not done.is_alive(), "ParallelTrainData.stop() hung"
    return time.monotonic() - t0


def test_parallel_loader_spawn_stop_restart(synth_root):
    kw = dict(dataset=synth_root, image_size=64, batch_size=2)
    ref = dataset.ParallelTrainData(DISYoloConfig(**kw), seed=1, workers=0)
    want = [ref.get() for _ in range(3)]
    data = dataset.ParallelTrainData(DISYoloConfig(**kw), seed=1, workers=2)
    data.start_prefetch()
    first = data.next_prefetched()
    for key in first:
        np.testing.assert_array_equal(first[key], want[0][key])
    assert _timed_stop(data) < 10.0
    assert data._pool is None and data._thread is None
    data.start_prefetch()                      # restartable
    again = data.next_prefetched()
    assert again["images"].shape == first["images"].shape
    assert _timed_stop(data) < 10.0
    pickle.dumps((DISYoloConfig(**kw), data.gt_labels))   # what a worker gets


def test_native_build_raises_without_compiler(monkeypatch, tmp_path):
    """A failed build raises; nothing falls back to the numpy engine."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        rasterize.fill_polygon([0, 4, 4], [0, 0, 4], 8, 8, "native")
    with pytest.raises(ValueError, match="unknown fill engine"):
        rasterize.fill_polygon([0, 4, 4], [0, 0, 4], 8, 8, "cv2")
    assert os.path.exists(native.SOURCE)

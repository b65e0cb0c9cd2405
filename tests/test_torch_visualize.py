"""Port parity of the overlay renderer (``utils/visualize.py``), the PNG
writer (``data/image_io.write_png``) and ``cli verify-gt``, against the
JAX package's renderer on seeded images, on the CPU."""

import os
import pickle
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image, ImageDraw

from dis_yolo_tpu.data import rasterize as jax_rasterize
from dis_yolo_tpu.utils import visualize as jax_vis
from dis_yolo_tpu_torch import cli
from dis_yolo_tpu_torch.data import image_io
from dis_yolo_tpu_torch.utils import visualize as vis
from tests.test_torch_eval import jax_numpy_fill  # noqa: F401

# the JAX overlays' masks from its numpy fill (tests/test_torch_eval.py)
pytestmark = pytest.mark.usefixtures("jax_numpy_fill")

CLASSES = ("crack", "spall", "rebar")


def read_png(path):
    """Decode a PNG written by ``write_png`` (8-bit RGB, filter 0 on
    every row) with zlib, checking every chunk's CRC."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks.setdefault(kind, b"")
        chunks[kind] += body
        pos += 12 + n
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        chunks[b"IHDR"])
    assert (depth, color, interlace) == (8, 2, 0) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert np.all(rows[:, 0] == 0)
    return rows[:, 1:].reshape(h, w, 3)


def random_instances(rng, h, w, n):
    insts = []
    for _ in range(n):
        x1, y1 = rng.randint(-3, w), rng.randint(-3, h)
        x2, y2 = x1 + rng.randint(0, w // 2), y1 + rng.randint(0, h // 2)
        inst = {"classname": (CLASSES + ("other",))[rng.randint(4)],
                "mask": rng.rand(h, w) > 0.7, "box": (x1, y1, x2, y2)}
        if rng.rand() < 0.5:
            inst["score"] = float(rng.rand())
        insts.append(inst)
    return insts


def test_blend_and_draw_match_jax():
    """``blend_mask`` and ``draw_instances`` (PIL present: labels drawn)
    equal the JAX renderer byte for byte, boxes over the image's edges,
    1-pixel and degenerate boxes included."""
    rng = np.random.RandomState(0)
    for trial in range(40):
        h, w = rng.randint(20, 120, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        mask = rng.rand(h, w) > 0.5
        cls = (CLASSES + ("other",))[trial % 4]
        np.testing.assert_array_equal(vis.blend_mask(img.copy(), mask, cls),
                                      jax_vis.blend_mask(img.copy(), mask, cls))
        insts = random_instances(rng, h, w, rng.randint(1, 6))
        np.testing.assert_array_equal(vis.draw_instances(img, insts),
                                      jax_vis.draw_instances(img, insts))


def test_draw_box_is_pils_rectangle():
    """Every box within 8 pixels of a 30x40 image's edges, against PIL's
    ``rectangle(width=2)``."""
    for x1 in range(-4, 44, 3):
        for y1 in range(-4, 34, 3):
            for dx in range(0, 8):
                dy = (x1 + y1 + dx) % 8
                box = (x1, y1, x1 + dx, y1 + dy)
                img = Image.new("RGB", (40, 30))
                ImageDraw.Draw(img).rectangle(box, outline=vis.BOX_COLOR,
                                              width=2)
                got = vis.draw_box(np.zeros((30, 40, 3), np.uint8), box)
                np.testing.assert_array_equal(got, np.asarray(img),
                                              err_msg=str(box))


def _label_boxes(insts, h, w):
    """Pixels PIL's labels may touch: each label's text box."""
    draw = ImageDraw.Draw(Image.new("RGB", (w, h)))
    touched = np.zeros((h, w), bool)
    for j, inst in enumerate(insts):
        x1, y1 = int(inst["box"][0]), int(inst["box"][1])
        l, t, r, b = draw.textbbox((x1, max(y1 - 10, 0)),
                                   vis._label(j, inst))
        touched[max(t, 0):max(b, 0), max(l, 0):max(r, 0)] = True
    return touched


def test_draw_without_pil_leaves_labels_off(monkeypatch, capsys, tmp_path):
    """With PIL blocked the renderer draws masks and boxes only: every
    pixel outside the labels' text boxes equals the JAX renderer's, and
    the commands say once that labels are off."""
    rng = np.random.RandomState(1)
    cases = []
    for _ in range(10):
        h, w = rng.randint(40, 120, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        insts = random_instances(rng, h, w, rng.randint(1, 5))
        cases.append((img, insts, jax_vis.draw_instances(img, insts),
                      _label_boxes(insts, h, w)))
    for name in ("PIL", "PIL.Image", "PIL.ImageDraw"):
        monkeypatch.setitem(sys.modules, name, None)
    assert not vis.have_labels()
    differ = 0
    for img, insts, want, touched in cases:
        got = vis.draw_instances(img, insts)
        np.testing.assert_array_equal(got[~touched], want[~touched])
        differ += int(np.any(got[touched] != want[touched]))
    assert differ == len(cases)      # the JAX renderer drew the labels
    root = make_split(str(tmp_path), {"val": 2})
    cli.main(["verify-gt", "--dataset", root, "--phase", "val"])
    err = capsys.readouterr().err
    assert err.count("no labels") == 1


def test_write_png_round_trip(tmp_path):
    rng = np.random.RandomState(2)
    for h, w in ((1, 1), (37, 53), (64, 3)):
        rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        path = str(tmp_path / f"x{h}.png")
        image_io.write_png(path, rgb)
        np.testing.assert_array_equal(read_png(path), rgb)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), rgb)
    with pytest.raises(ValueError, match="H, W, 3"):
        image_io.write_png(str(tmp_path / "bad.png"), np.zeros((4, 4)))


def make_split(root, phases, sizes=((48, 64), (64, 48)), seed=0):
    """A seeded split written as P6 under ``.jpg`` names: 1-3 darkened
    polygons per image, their VIA regions in ``cache/
    ground_truth_cache.pkl`` and the stems in ``cache/<phase>.txt``."""
    rng = np.random.RandomState(seed)
    for phase, n in phases.items():
        img_dir = os.path.join(root, phase, "images")
        cache_dir = os.path.join(root, phase, "cache")
        os.makedirs(img_dir)
        os.makedirs(cache_dir)
        annotations, stems = [], []
        for i in range(n):
            h, w = sizes[i % 2]
            img = rng.normal(140, 25, (h, w, 3))
            regions = {}
            for r in range(rng.randint(1, 4)):
                cx, cy = rng.randint(w // 4, 3 * w // 4), rng.randint(h // 4, 3 * h // 4)
                ang = np.sort(rng.uniform(0, 2 * np.pi, rng.randint(4, 9)))
                rad = rng.uniform(4, min(h, w) / 3, ang.size)
                xs = np.clip(cx + rad * np.cos(ang), 0, w - 1).astype(int).tolist()
                ys = np.clip(cy + rad * np.sin(ang), 0, h - 1).astype(int).tolist()
                shape = [{"type": "out", "all_points_x": xs, "all_points_y": ys}]
                img[jax_rasterize.instance_mask(shape, h, w, engine="numpy")] *= 0.4
                regions[str(r)] = {"region_attributes": CLASSES[rng.randint(3)],
                                   "shape_attributes": shape}
            stem = f"{phase}{i:04d}"
            image_io.write_ppm(os.path.join(img_dir, stem + ".jpg"),
                               img.clip(0, 255).astype(np.uint8))
            annotations.append({"filename": stem + ".jpg", "regions": regions,
                                "size": [h, w]})
            stems.append(stem)
        with open(os.path.join(cache_dir, "ground_truth_cache.pkl"), "wb") as f:
            pickle.dump(annotations, f)
        with open(os.path.join(cache_dir, f"{phase}.txt"), "w") as f:
            f.write("".join(s + "\n" for s in stems))
    return root


def test_verify_gt_matches_jax_overlays(tmp_path, capsys):
    """``cli verify-gt`` writes one ``<stem>.png`` per image of a P6
    split, each equal to the JAX renderer's overlay of the same ground
    truth (JAX's numpy polygon fill), labels included; ``--limit``."""
    root = make_split(str(tmp_path), {"train": 3})
    cli.main(["verify-gt", "--dataset", root, "--phase", "train"])
    assert "wrote 3 verification overlays" in capsys.readouterr().out
    with open(os.path.join(root, "train", "cache",
                           "ground_truth_cache.pkl"), "rb") as f:
        annotations = pickle.load(f)
    out_dir = os.path.join(root, "train", "verify")
    assert sorted(os.listdir(out_dir)) == [f"train{i:04d}.png" for i in range(3)]
    for a in annotations:
        h, w = a["size"]
        img = image_io.read_image(os.path.join(root, "train", "images",
                                               a["filename"]))
        insts = []
        for r in a["regions"].values():
            mask = jax_rasterize.instance_mask(r["shape_attributes"], h, w,
                                               engine="numpy")
            bb = jax_rasterize.mask_to_box(mask)
            insts.append({"classname": r["region_attributes"], "mask": mask,
                          "box": bb})
        got = read_png(os.path.join(out_dir, a["filename"][:-4] + ".png"))
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, jax_vis.draw_instances(img, insts))
    limited = vis.render_groundtruth(root, "train", str(tmp_path / "lim"),
                                     limit=1)
    assert [os.path.basename(p) for p in limited] == ["train0000.png"]

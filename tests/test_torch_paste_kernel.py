"""The contract of kernel K5 (``dis_yolo_tpu_torch/csrc/paste.cu``, the
mask paste on CUDA) that the CPU can check, at 64-96 px:

  * the tap tables: the dense one-axis matrices rebuilt from
    ``paste_taps``' tables (both axes in one [..., D, 2, L] set) with K5's
    weight rule (a0 = 1 - w and a1 = w on
    two taps, one weight (1 - w) + w on coinciding taps, zeros outside the
    box) equal the port's ``_axis_matrix`` and the benchmark reference's,
    bit for bit, with boxes on the map's edges, 1-pixel boxes, crops that
    round to no score-map pixel, an image with no valid row and class 255;
  * the operator ``dis_yolo::paste_masks``: its fake registration gives
    [B,D,H0,W0] bool and [B,H0,W0] uint8 ([B,0,0] without the semantic
    map), its CPU registration equals the dense paste of today's route
    and of the benchmark reference, the wrapper takes any leading
    dimensions, refuses wrong shapes and placements, and counts no K5
    launch on CPU tensors.

The kernel itself runs on the card only: ``chip_smoke.py``'s
``check_paste`` holds it against the dense route there.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from dis_yolo_tpu_torch.ops import custom_ops, paste
from dis_yolo_tpu_torch.utils import profiling
from port_bench.reference import post as ref_post

NET = 96


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _dets(b, d, h0, w0, s, seed):
    """[b,d,6] letterboxed detections on an h0 x w0 photo: random boxes in
    the window, then in every image the whole window, a box on its bottom
    and right edges, a 1-pixel box, a 1-pixel-tall box along the bottom,
    a box inside one score-map pixel (its crop rounds to nothing), an
    inverted box and a padding row; classes 255, 300 and -1; the last
    image all padding."""
    g = torch.Generator().manual_seed(seed)
    sc = min(NET / h0, NET / w0)
    nh, nw = int(h0 * sc), int(w0 * sc)
    oy, ox = (NET - nh) // 2 / NET, (NET - nw) // 2 / NET
    fy, fx = nh / NET, nw / NET
    py, px = fy / h0, fx / w0
    ky = round((oy + fy / 2) * s)      # a score-map row inside the window
    u = torch.rand((b, d, 4), generator=g)
    y = torch.sort(u[..., 0::2], -1).values * fy + oy
    x = torch.sort(u[..., 1::2], -1).values * fx + ox
    boxes = torch.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], -1)
    boxes[:, :6] = torch.tensor([
        [oy, ox, oy + fy, ox + fx],
        [oy + fy / 2, ox + fx / 3, oy + fy, ox + fx],
        [oy + 5 * py, ox + 7 * px, oy + 6 * py, ox + 8 * px],
        [oy + (h0 - 1) * py, ox, oy + fy, ox + 9 * px],
        [(ky - 0.45) / s, ox + 0.2 * fx, (ky + 0.45) / s, ox + 0.6 * fx],
        [oy + 0.7 * fy, ox + 0.2 * fx, oy + 0.2 * fy, ox + 0.9 * fx]])
    cls = torch.randint(0, 3, (b, d), generator=g).float()
    cls[:, :3] = torch.tensor([255.0, 300.0, -1.0])
    score = torch.rand((b, d), generator=g) * 0.9 + 0.05
    score[:, d - 1] = 0.0
    score[-1] = 0.0
    return torch.cat([boxes, cls[..., None], score[..., None]], -1)


def _masks(b, d, s, seed):
    g = torch.Generator().manual_seed(seed + 1)
    return torch.sigmoid(4.0 * torch.randn((b, d, s, s), generator=g))


def _k5_matrix(taps, mask_size):
    """The dense one-axis matrix K5's weights make: a0 at i0, a1 added at
    i1 (a zero on coinciding taps)."""
    i0, i1, w, inside = taps
    two = i0 != i1
    omw = 1.0 - w
    a0 = torch.where(inside, torch.where(two, omw, omw + w), 0.0)
    a1 = torch.where(inside & two, w, 0.0)
    m = torch.zeros(i0.shape + (mask_size,))
    m.scatter_(-1, i0.long()[..., None], a0[..., None])
    return m.scatter_add(-1, i1.long()[..., None], a1[..., None])


# mask size and photo size: the photo 1.5-3 times as fine as the score
# map, as on the serving path (288 or 576 against 720 x 960)
CASES = [(32, (72, 96), 0), (48, (96, 72), 1), (24, (61, 83), 2),
         (64, (96, 96), 3)]


@pytest.mark.parametrize("s,hw,seed", CASES)
def test_tap_tables_rebuild_the_dense_matrices(s, hw, seed):
    h0, w0 = hw
    dets = _dets(3, 10, h0, w0, s, seed)
    valid, taps = paste.paste_taps(dets, s, h0, w0, NET)
    rows, cols = paste.axis_tables(taps, 0, h0), paste.axis_tables(taps, 1, w0)
    box = ref_post.original_boxes(dets[..., :4], h0, w0, NET)
    crop = torch.round(dets[..., :4] * s).to(torch.int32)
    for taps, out, a, bb in ((rows, h0, 0, 2), (cols, w0, 1, 3)):
        got = _k5_matrix(taps, s)
        assert torch.equal(got, paste._axis_matrix(taps, s))
        assert torch.equal(got, ref_post._axis_matrix(
            out, box[..., a], box[..., bb], crop[..., a], crop[..., bb], s))
    i0, i1, _, inside = rows
    # the edge cases are there: coinciding taps inside a box, a valid row
    # whose crop rounds to nothing, an image with no valid row
    assert bool(((i0 == i1) & inside).any())
    no_crop = valid & ~(rows[3].any(-1) & cols[3].any(-1))
    assert bool(no_crop.any()) and not bool(valid[-1].any())
    assert bool(((box[..., 2] - box[..., 0] == 1) & valid).any())


def _op_args(masks, dets, h0, w0):
    valid, taps = paste.paste_taps(dets, masks.shape[-1], h0, w0, NET)
    cls = torch.clamp(dets[..., 4].to(torch.int32), 0, 255)
    return valid, taps, cls


def test_fake_registration_gives_the_output_shapes():
    masks, dets = _masks(2, 8, 32, 0), _dets(2, 8, 40, 56, 32, 0)
    valid, taps, cls = _op_args(masks, dets, 40, 56)
    with FakeTensorMode() as mode:
        args = [mode.from_tensor(t) for t in (masks, *taps, valid, cls)]
        full, sem = torch.ops.dis_yolo.paste_masks(*args, 40, 56, True)
        assert (full.shape, full.dtype) == ((2, 8, 40, 56), torch.bool)
        assert (sem.shape, sem.dtype) == ((2, 40, 56), torch.uint8)
        _, sem = torch.ops.dis_yolo.paste_masks(*args, 40, 56, False)
        assert sem.shape == (2, 0, 0)


@pytest.mark.parametrize("s,hw,seed", CASES)
def test_cpu_registration_equals_the_dense_paste(s, hw, seed):
    h0, w0 = hw
    masks, dets = _masks(3, 10, s, seed), _dets(3, 10, h0, w0, s, seed)
    valid, taps, cls = _op_args(masks, dets, h0, w0)
    before = profiling.counters().get("kernel.k5", 0)
    full, sem = torch.ops.dis_yolo.paste_masks(masks, *taps, valid, cls, h0,
                                               w0, True)
    want = ref_post.paste(masks, dets, h0, w0, NET)
    route = paste.paste_masks_batch(masks, dets, h0, w0, NET)
    for got, ref, port in zip((full, valid, sem), want, route):
        assert torch.equal(got, ref) and torch.equal(got, port)
    # class 255 paints 0, so only the masks tell it from no detection
    order = torch.arange(1, 11, dtype=torch.uint8)[None, :, None, None]
    painted_by_0 = (full.to(torch.uint8) * order).amax(1) == 1
    assert bool(painted_by_0.any()) and not bool(sem[painted_by_0].any())
    assert full.any() and not full[-1].any() and not sem[-1].any()
    # one image without a batch dimension, and no semantic map
    one, none = custom_ops.paste_masks_cuda(
        masks[0], tuple(t[0] for t in taps), valid[0], cls[0], h0, w0)
    assert torch.equal(one, full[0]) and none is None
    assert profiling.counters().get("kernel.k5", 0) == before


def test_wrapper_refuses_wrong_shapes_and_placements():
    masks, dets = _masks(2, 8, 32, 0), _dets(2, 8, 40, 56, 32, 0)
    valid, taps, cls = _op_args(masks, dets, 40, 56)
    with pytest.raises(ValueError, match="taps"):
        custom_ops.paste_masks_cuda(masks, tuple(t[:1] for t in taps), valid,
                                    cls, 40, 56)
    with pytest.raises(ValueError, match="masks"):
        custom_ops.paste_masks_cuda(masks[..., :31], taps, valid, cls, 40, 56)
    with pytest.raises(ValueError, match="four tables"):
        custom_ops.paste_masks_cuda(masks, taps[:3], valid, cls, 40, 56)
    with pytest.raises(ValueError, match="positions"):
        custom_ops.paste_masks_cuda(masks, taps, valid, cls, 40, 57)
    with pytest.raises(ValueError, match="CUDA device"):
        custom_ops.paste_masks_cuda(masks.to("meta"), taps, valid, cls, 40, 56)

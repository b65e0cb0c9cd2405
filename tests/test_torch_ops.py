"""Port parity of the serving path's ops: ``dis_yolo_tpu_torch.ops`` vs
``dis_yolo_tpu.ops`` on the same numpy inputs, on the CPU.

The Pallas kernels run in interpret mode, the CUDA kernels' wrappers take
their plain PyTorch versions (the tensors lie on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.ops import boxes as jax_boxes
from dis_yolo_tpu.ops import decode as jax_decode
from dis_yolo_tpu.ops import mask_assembly as jax_ma
from dis_yolo_tpu.ops import nms as jax_nms
from dis_yolo_tpu.ops import paste as jax_paste
from dis_yolo_tpu.ops.pallas_assembly import (_assembly_px,
                                              assemble_masks_batch_pallas)
from dis_yolo_tpu.ops.pallas_nms import nms_pallas
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.ops import boxes, decode, mask_assembly, nms, paste
from dis_yolo_tpu_torch.ops.cuda_assembly import assemble_masks_batch_cuda
from dis_yolo_tpu_torch.ops.cuda_nms import nms_cuda


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def sorted_boxes(rng, n):
    b = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    return np.stack([np.minimum(b[:, 0], b[:, 2]), np.minimum(b[:, 1], b[:, 3]),
                     np.maximum(b[:, 0], b[:, 2]), np.maximum(b[:, 1], b[:, 3])],
                    axis=1)


# ---------------------------------------------------------------- boxes/decode

def test_boxes_ulp_parity():
    rng = np.random.RandomState(1)
    cxcywh = rng.uniform(0, 1, (2, 200, 4)).astype(np.float32)
    windows = np.array([[0, 0, 1, 1], [0.1, 0.05, 0.9, 0.95]], np.float32)
    got = boxes.clip_boxes(boxes.cxcywh_to_yxyx(T(cxcywh)), T(windows))
    for i in range(2):
        want = jax_boxes.clip_boxes(jax_boxes.cxcywh_to_yxyx(
            jnp.asarray(cxcywh[i])), jnp.asarray(windows[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)
    a, b = sorted_boxes(rng, 50), sorted_boxes(rng, 40)
    b[:5] = b[5:6]                                  # duplicates: IoU 1
    b[5:8, 2:] = b[5:8, :2]                         # zero-area boxes
    want = np.asarray(jax_boxes.iou_matrix_yxyx(jnp.asarray(a), jnp.asarray(b)))
    got = boxes.iou_matrix_yxyx(T(a), T(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    zero = np.zeros((3, 4), np.float32)             # union 0 -> IoU 0
    assert not boxes.iou_matrix_yxyx(T(zero), T(zero)).any()


def test_decode_ulp_parity():
    """decode_all at the 576 input's grids (72/36/18)."""
    rng = np.random.RandomState(2)
    cfg, jcfg = DISYoloConfig(), JaxConfig()
    raws = [rng.randn(2, g, g, 3, 8).astype(np.float32) for g in (72, 36, 18)]
    got = decode.decode_all([T(r) for r in raws], cfg)
    want = jax_decode.decode_all([jnp.asarray(r) for r in raws], jcfg)
    for g, w in zip(got, want):
        for name in decode.ScalePrediction._fields:
            np.testing.assert_allclose(getattr(g, name).numpy(),
                                       np.asarray(getattr(w, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    off = decode.cell_offsets(3, 5).numpy()
    np.testing.assert_array_equal(off, np.asarray(jax_decode.cell_offsets(3, 5)))


# ---------------------------------------------------------------- NMS

def _candidates(boxes_yxyx, scores, classids, c=3):
    """Flat candidates whose class argmax/max are classids/1.0 and whose
    conf is ``scores`` (tests/test_nms.py's construction)."""
    n = len(scores)
    prob = np.full((n, c), 1e-6, np.float32)
    prob[np.arange(n), classids] = 1.0
    y1, x1, y2, x2 = boxes_yxyx.T
    cxcywh = np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], 1)
    return scores.astype(np.float32), prob, cxcywh.astype(np.float32)


def _adversarial_cluster(rng, n_cluster, n_spread):
    cl = np.tile(np.array([[0.30, 0.30, 0.50, 0.50]], np.float32),
                 (n_cluster, 1))
    cl += rng.uniform(-0.005, 0.005, cl.shape).astype(np.float32)
    g = int(np.ceil(np.sqrt(n_spread)))
    ys, xs = np.divmod(np.arange(n_spread), g)
    sp = np.stack([0.02 + ys / g * 0.9, 0.02 + xs / g * 0.9,
                   0.02 + ys / g * 0.9 + 0.03, 0.02 + xs / g * 0.9 + 0.03],
                  axis=1).astype(np.float32)
    scores = np.concatenate([0.9 - np.arange(n_cluster) * 1e-4,
                             0.5 - np.arange(n_spread) * 1e-4])
    return (np.concatenate([cl, sp]), scores.astype(np.float32),
            np.zeros(n_cluster + n_spread, np.int64))


def _ladder_and_ties(rng):
    n = 24
    y = np.linspace(0.0, 0.46, n).astype(np.float32)
    ladder = np.stack([y, np.full(n, 0.1, np.float32), y + 0.5,
                       np.full(n, 0.6, np.float32)], axis=1)
    cases = [(ladder, np.linspace(0.9, 0.5, n).astype(np.float32),
              np.zeros(n, np.int64))]
    for _ in range(3):
        m = 60
        centers = rng.uniform(0.2, 0.8, (6, 2))
        lo = np.clip(centers[rng.randint(0, 6, m)]
                     + rng.uniform(-0.03, 0.03, (m, 2)) - 0.1, 0, 1)
        bx = np.concatenate([lo, np.clip(lo + 0.2, 0, 1)], 1).astype(np.float32)
        sc = (np.round(rng.uniform(0.3, 1.0, m) * 8) / 8).astype(np.float32)
        cases.append((bx, sc, rng.randint(0, 3, m)))
    return cases


def _nms_cases():
    """(name, config kwargs, [(boxes, scores, classids, window)]): the
    boundary cases of tests/test_nms.py, each group one batch."""
    rng = np.random.RandomState(5)
    small = dict(image_size=96, test_size=96, pre_nms_top_k=64)
    random_trials = []
    for _ in range(4):
        n = 40
        bx = rng.uniform(0, 1, (n, 4)).astype(np.float32)
        bx[:, 2:] = np.minimum(bx[:, :2] + np.abs(bx[:, 2:] - bx[:, :2]) * 0.5
                               + 0.05, 1.0)
        random_trials.append((bx, rng.uniform(0, 1, n).astype(np.float32),
                              rng.randint(0, 3, n)))
    full = np.array([0, 0, 1, 1], np.float32)
    edge = [
        (np.array([[0.1, 0.1, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9]], np.float32),
         np.array([0.25, 0.251], np.float32), np.array([0, 1])),
        (np.array([[0.2, 0.2, 0.7, 0.7], [0.2, 0.2, 0.7, 0.7]], np.float32),
         np.array([0.9, 0.8], np.float32), np.array([0, 1])),
    ]
    window = (np.array([[0.0, 0.0, 1.0, 1.0]], np.float32),
              np.array([0.9], np.float32), np.array([0]),
              np.array([0.1, 0.2, 0.8, 0.9], np.float32))
    return [
        ("random", small, [c + (full,) for c in random_trials]),
        ("edges", small, [c + (full,) for c in edge] + [window]),
        # shortlist underfill: image 0 falls back, image 1 does not
        ("fallback16", dict(image_size=96, test_size=96, pre_nms_top_k=16),
         [_adversarial_cluster(rng, 20, 25) + (full,),
          _adversarial_cluster(rng, 5, 10) + (full,)]),
        ("fallback512", dict(image_size=96, test_size=96),
         [_adversarial_cluster(rng, 550, 29) + (full,)]),
        ("ladder_ties", small, [c + (full,) for c in _ladder_and_ties(rng)]),
    ]


def _pad_batch(group):
    """Stack candidate sets of different sizes: pad with zero-score rows."""
    n = max(len(c[1]) for c in group)
    conf = np.zeros((len(group), n), np.float32)
    prob = np.full((len(group), n, 3), 1.0 / 3, np.float32)
    coord = np.zeros((len(group), n, 4), np.float32)
    for i, (bx, sc, cl, _) in enumerate(group):
        c, p, x = _candidates(bx, sc, cl)
        conf[i, :len(c)], prob[i, :len(c)], coord[i, :len(c)] = c, p, x
    return conf, prob, coord, np.stack([g[3] for g in group])


def assert_dets_match(got, want, atol=2e-5):
    """Keep set, class ids and order exact; boxes and scores within atol."""
    np.testing.assert_array_equal(got[..., 5] > 0, want[..., 5] > 0)
    np.testing.assert_array_equal(got[..., 4], want[..., 4])
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=atol)
    np.testing.assert_allclose(got[..., 5], want[..., 5], rtol=0, atol=atol)


@pytest.mark.parametrize("engine", ["fixpoint", "scan"])
@pytest.mark.parametrize("case", range(5))
def test_filter_detections_parity(case, engine):
    name, kw, group = _nms_cases()[case]
    cfg = DISYoloConfig(nms_engine=engine, **kw)
    jcfg = JaxConfig(nms_engine=engine, **kw)
    conf, prob, coord, windows = _pad_batch(group)
    got = nms.filter_candidates(T(conf), T(prob), T(coord), T(windows), cfg,
                                cfg.obj_threshold).numpy()
    assert got.shape == (len(group), cfg.max_detection, 6)
    for i in range(len(group)):
        want = np.asarray(jax_nms.filter_detections_single(
            jnp.asarray(conf[i]), jnp.asarray(prob[i]), jnp.asarray(coord[i]),
            jnp.asarray(windows[i]), jcfg, jcfg.obj_threshold))
        assert_dets_match(got[i], want)
    assert (got[..., 5] > 0).sum() > 0, name


def _nms_kernel_case(rng, k, ties):
    bx = sorted_boxes(rng, k)
    bx[:, 2:] += 0.05
    sc = rng.uniform(0, 1, k).astype(np.float32)
    if ties:
        sc = (np.round(sc * 16) / 16).astype(np.float32)
    sc = np.sort(sc)[::-1].copy()
    cl = rng.randint(0, 3, k).astype(np.int32)
    return bx, sc, cl, sc > rng.uniform(0.1, 0.6)


@pytest.mark.parametrize("k,max_det,ties", [(64, 10, False), (64, 10, True),
                                            (512, 30, True)])
def test_nms_kernel_plain_index_exact(k, max_det, ties):
    """K2's plain version (nms_cuda on CPU tensors) is index-exact against
    nms_pallas(interpret=True) and the JAX _select_suppress_nms, with
    forced score ties; two images per launch."""
    rng = np.random.RandomState(k + max_det + ties)
    imgs = [_nms_kernel_case(rng, k, ties) for _ in range(2)]
    stack = [np.stack(x) for x in zip(*imgs)]
    got = nms_cuda(*(T(x) for x in stack), max_det, 0.3).numpy()
    assert got.dtype == np.int64 and got.shape == (2, max_det)
    assert nms_cuda.launches == 0          # CPU tensors: no kernel launch
    for i, (bx, sc, cl, va) in enumerate(imgs):
        args = [jnp.asarray(x) for x in (bx, sc, cl, va)]
        want = np.asarray(nms_pallas(*args, max_det, 0.3, interpret=True))
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(got[i], np.asarray(
            jax_nms._select_suppress_nms(*args, 0.3, max_det)))


def test_nms_kernel_plain_edge_cases():
    """All-invalid -> all -1; identical boxes -> only the first survives."""
    rng = np.random.RandomState(9)
    bx, sc, cl, _ = _nms_kernel_case(rng, 32, False)
    got = nms_cuda(T(bx[None]), T(sc[None]), T(cl[None]),
                   torch.zeros(1, 32, dtype=torch.bool), 8, 0.3)
    assert (got == -1).all()
    dup = np.tile(np.array([[0.1, 0.1, 0.5, 0.5]], np.float32), (16, 1))
    got = nms_cuda(T(dup[None]), T(np.linspace(0.9, 0.3, 16, dtype=np.float32)[None]),
                   torch.zeros(1, 16, dtype=torch.int32),
                   torch.ones(1, 16, dtype=torch.bool), 8, 0.3)[0]
    assert got[0] == 0 and (got[1:] == -1).all()


def test_fixpoint_and_full_engines_match_jax():
    rng = np.random.RandomState(11)
    bx, sc, cl, va = _nms_kernel_case(rng, 64, True)
    args = [jnp.asarray(x) for x in (bx, sc, cl, va)]
    for port_fn, jax_fn in ((nms._fixpoint_nms, jax_nms._fixpoint_nms),
                            (nms._select_suppress_nms_full,
                             jax_nms._select_suppress_nms_full)):
        got = port_fn(T(bx[None]), T(sc[None]), T(cl[None]), T(va[None]),
                      0.3, 30)[0].numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_fn(*args, 0.3, 30)))


# ---------------------------------------------------------------- assembly

def _assembly_case(seed, s, k, d):
    rng = np.random.RandomState(seed)
    sm = rng.randn(s, s, k * k).astype(np.float32)
    bx = sorted_boxes(rng, d)
    bx[-2:] = 0.0                                   # padding rows
    return sm, bx


@pytest.mark.parametrize("force_tiled", [False, True])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_assembly_kernel_plain_bit_exact(k, force_tiled):
    """K1's plain version: logits bit-exact against
    assemble_masks_batch_pallas(interpret=True) in both TPU layouts;
    sigmoid within 1e-6 of the Pallas sigmoid (k=3; of the sigmoid of
    its logits for k=5/7) inside the box and exactly 0 outside."""
    sms, bxs = zip(*(_assembly_case(7 + k + i, 64, k, 6) for i in range(2)))
    sms, bxs = np.stack(sms), np.stack(bxs)
    logits = assemble_masks_batch_cuda(T(sms), T(bxs), k,
                                       apply_sigmoid=False).numpy()
    probs = assemble_masks_batch_cuda(T(sms), T(bxs), k).numpy()
    assert assemble_masks_batch_cuda.launches == 0
    want = np.asarray(assemble_masks_batch_pallas(
        jnp.asarray(sms), jnp.asarray(bxs), k, apply_sigmoid=False,
        interpret=True, force_tiled=force_tiled))
    np.testing.assert_array_equal(logits, want)
    if k == 3:      # the Pallas sigmoid itself, once per layout
        want_p = np.asarray(assemble_masks_batch_pallas(
            jnp.asarray(sms), jnp.asarray(bxs), k, apply_sigmoid=True,
            interpret=True, force_tiled=force_tiled))
    else:
        want_p = np.where(want != 0, 1 / (1 + np.exp(-want)), 0.0)
    np.testing.assert_allclose(probs, want_p, rtol=0, atol=1e-6)
    for i in range(2):
        inside = np.asarray(jax_ma.assemble_masks(
            jnp.asarray(sms[i]), jnp.asarray(bxs[i]), k)) != 0
        assert (probs[i][~inside] == 0).all()
        assert (probs[i][inside] > 0).all()
        assert not probs[i][-2:].any()              # padding rows


def _edge_boxes(rng, s, d):
    """Normalized boxes at the edges of an S-pixel map: the whole map, one
    touching the bottom and right edges (y2 = x2 = S), two 1-pixel boxes
    (one the last pixel), an inverted box, one past the map's edges, two
    zero (padding) rows; the rest random."""
    bx = sorted_boxes(rng, d)
    r, c = rng.randint(0, s, 2)
    bx[:6] = [[0, 0, 1, 1], [0.5, 0.25, 1, 1],
              [r / s, c / s, (r + 1) / s, (c + 1) / s],
              [(s - 1) / s, (s - 1) / s, 1, 1],
              [0.7, 0.2, 0.2, 0.9], [-0.1, 0.3, 0.4, 1.2]]
    bx[-2:] = 0.0
    return bx


@pytest.mark.parametrize("k", [3, 5])
def test_assembly_kernel_plain_edges(k):
    """K1's plain version at odd S (rows off the 16-byte grid on the card)
    with boxes on the map's edges: logits bit-exact against
    assemble_masks_batch_pallas(interpret=True) for normalized boxes and
    against _assembly_px for pixel boxes; channel planes give the same
    logits as the NHWC map."""
    s = 45
    rng = np.random.RandomState(20 + k)
    sms = rng.randn(2, s, s, k * k).astype(np.float32)
    bxs = np.stack([_edge_boxes(rng, s, 10) for _ in range(2)])
    logits = assemble_masks_batch_cuda(T(sms), T(bxs), k,
                                       apply_sigmoid=False).numpy()
    np.testing.assert_array_equal(logits, np.asarray(assemble_masks_batch_pallas(
        jnp.asarray(sms), jnp.asarray(bxs), k, apply_sigmoid=False,
        interpret=True)))
    px = np.round(bxs * s).astype(np.float32)
    got_px = assemble_masks_batch_cuda(T(sms), T(px), k, apply_sigmoid=False,
                                       pixel_boxes=True).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got_px[i], np.asarray(_assembly_px(
            jnp.transpose(jnp.asarray(sms[i]), (2, 0, 1)), jnp.asarray(px[i]),
            k, interpret=True)))
    planes = assemble_masks_batch_cuda(T(sms.transpose(0, 3, 1, 2)), T(bxs), k,
                                       apply_sigmoid=False, planes=True)
    np.testing.assert_array_equal(planes.numpy(), logits)
    assert (logits[:, 0] != 0).all()                # the whole map
    assert (logits[:, 3, -1, -1] != 0).all() and (logits[:, 3] != 0).sum() == 2
    assert not logits[:, 4].any() and not logits[:, -2:].any()
    assert assemble_masks_batch_cuda.launches == 0


def test_gather_assembly_matches_jax():
    """The gather form (mask_assembly) is bit-exact to the JAX gather;
    its sigmoid path writes sigmoid(0) = 0.5 outside the box like JAX."""
    sm, bx = _assembly_case(3, 48, 3, 10)
    got = mask_assembly.assemble_masks(T(sm), T(bx), 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jax_ma.assemble_masks(jnp.asarray(sm), jnp.asarray(bx), 3)))
    got = mask_assembly.assemble_masks_batch(T(sm[None]), T(bx[None]), 3)
    want = jax_ma.assemble_masks_batch(jnp.asarray(sm[None]),
                                       jnp.asarray(bx[None]), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    box_px = np.round(bx[0] * 48).astype(np.float32)
    np.testing.assert_array_equal(
        mask_assembly.box_inside_mask(T(box_px), 48).numpy(),
        np.asarray(jax_ma.box_inside_mask(jnp.asarray(box_px), 48)))
    np.testing.assert_array_equal(
        mask_assembly.assemble_mask_single(T(sm), T(box_px), 3).numpy(),
        np.asarray(jax_ma.assemble_mask_single(jnp.asarray(sm),
                                               jnp.asarray(box_px), 3)))


# ---------------------------------------------------------------- paste

def _dyadic_boxes(rng, n, q=256):
    lo = rng.randint(0, q - 24, (n, 2)) / q
    hi = lo + rng.randint(12, 24, (n, 2)) / q
    return np.concatenate([lo, np.minimum(hi, 1.0)], 1).astype(np.float32)


@pytest.mark.parametrize("image_hw", [(96, 96), (192, 96), (131, 77)])
def test_paste_matches_jax(image_hw):
    """paste_masks_batch vs the JAX one: exact booleans (masks, validity,
    semantic map) and exact original-pixel boxes."""
    ih, iw = image_hw
    rng = np.random.RandomState(ih + iw)
    net, s, d = 96, 48, 12
    dets = np.zeros((2, d, 6), np.float32)
    dets[..., :4] = _dyadic_boxes(rng, 2 * d).reshape(2, d, 4)
    dets[..., 4] = rng.randint(0, 3, (2, d))
    dets[..., 5] = rng.uniform(0.3, 1.0, (2, d))
    dets[0, 3] = 0.0                                  # padding row
    dets[1, 7, :4] = [0.5, 0.5, 0.5 + 1e-4, 0.5 + 1e-4]   # degenerate box
    # sharp masks keep interpolated values off the 0.5 knife edge
    masks = 1.0 / (1.0 + np.exp(-5.0 * rng.randn(2, d, s, s).astype(np.float32)))
    got = paste.paste_masks_batch(T(masks), T(dets), ih, iw, net)
    want = jax_paste.paste_masks_batch(jnp.asarray(masks), jnp.asarray(dets),
                                       ih, iw, net)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any() and not got[1][0, 3] and not got[1][1, 7]
    np.testing.assert_array_equal(
        paste.correct_boxes_device(T(dets[..., :4]), ih, iw, net, net).numpy(),
        np.asarray(jax_paste.correct_boxes_device(jnp.asarray(dets[..., :4]),
                                                  ih, iw, net, net)))

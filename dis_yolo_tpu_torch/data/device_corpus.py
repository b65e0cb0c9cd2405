"""The training split resident on the device: each step the host ships
the placement decisions, and the batch is assembled on the device (the
counterpart of ``dis_yolo_tpu/data/device_corpus.py``).

  * ``build_host_corpus`` decodes and rasterizes the split once (the
    census of ``dataset.build_example``: the same masks, boxes, classes
    and keep filter) into fixed-shape padded arrays; ``upload_corpus``
    copies them to the device once.
  * ``CorpusTrainData`` is the wire loader with its pixel work taken
    out: the same epoch shuffle and ``RandomState`` stream, the shared
    ``dataset.sample_placement`` / ``boxes_to_net`` draws, and per
    example it returns the corpus row, the placement (new_h, new_w, dy,
    dx) and the placed boxes, a few hundred bytes.
  * ``make_assemble_fn`` builds the standard 7-field batch on the
    device: bilinear resize-and-place of image and masks (OpenCV's
    pixel-center convention, edge-clamped taps, float32, round half to
    even), and the YOLO label grids (best anchor by wh-IoU, first box
    wins an occupied cell, a box with no anchor IoU > 0 dropped).

Against the JAX package: equal, the pixels too (the multiply-adds XLA
fuses are fused here).  Against the wire loader (``host_augs=False``):
decisions, true boxes and grids are equal; image pixels differ by at
most 1 LSB (OpenCV's fixed-point resize against float bilinear) and mask
pixels only at .5 bilinear knife edges.  Needs ``cfg.device_side_augs``: the host no
longer holds the pixels to flip.

Data parallelism: every rank uploads the whole corpus to its device (the
JAX package replicates it over the mesh), the same seeded
``CorpusTrainData`` makes the global batch's decisions on every rank,
and each rank assembles its own rows of them (``parallel.sharding``'s
``Mesh.rows``; the Solver hands the mesh corpus step those rows).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data import dataset, rasterize
from dis_yolo_tpu_torch.data.dataset import (DefectTrainData, boxes_to_net,
                                             load_labels, sample_placement)
from dis_yolo_tpu_torch.data.image_io import read_image


# --------------------------------------------------------------------------
# corpus build (host, once) + upload
# --------------------------------------------------------------------------

@dataclasses.dataclass
class HostCorpus:
    """The decoded split in fixed-shape padded arrays (host copy).

    images       [N, Hm, Wm, 3] uint8 (zero-padded to the largest image)
    masks_packed [N, T, ceil(Hm*Wm/8)] uint8 (np.packbits rows of the
                 kept instance masks, in build_example's census order)
    sizes        [N, 2] int32 (ih, iw) of each image
    boxes        [N, T, 4] float32 (x1, y1, x2, y2) px, from the masks
    classids     [N, T] int32
    nvalid       [N] int32
    """
    images: np.ndarray
    masks_packed: np.ndarray
    sizes: np.ndarray
    boxes: np.ndarray
    classids: np.ndarray
    nvalid: np.ndarray

    @property
    def n(self) -> int:
        return int(self.images.shape[0])

    @property
    def hw_max(self) -> Tuple[int, int]:
        return int(self.images.shape[1]), int(self.images.shape[2])

    def nbytes(self) -> int:
        return sum(getattr(self, f.name).nbytes
                   for f in dataclasses.fields(self))


def build_host_corpus(cfg: DISYoloConfig, phase: str = "train",
                      labels: Optional[List[Dict]] = None,
                      load_image=read_image) -> HostCorpus:
    """Decode and rasterize the whole split once (``build_example``'s
    census, with the loader's polygon fill ``dataset.FILL_ENGINE``)."""
    t = cfg.max_box_per_image
    c2i = cfg.class_to_ind()
    labels = labels if labels is not None else load_labels(cfg, phase)

    images, all_masks, sizes = [], [], []
    boxes_all = np.zeros((len(labels), t, 4), np.float32)
    cls_all = np.zeros((len(labels), t), np.int32)
    nvalid = np.zeros(len(labels), np.int32)
    for i, label in enumerate(labels):
        image = load_image(label["imname"])
        ih, iw = image.shape[:2]
        class_names = label["class_names"][:t]
        polys = label["polygons"][:t]
        masks = rasterize.instance_masks(polys, ih, iw, len(polys),
                                         dataset.FILL_ENGINE)
        boxes, keep = [], []
        for j in range(masks.shape[0]):
            bb = rasterize.mask_to_box(masks[j])
            if bb is None:
                continue
            boxes.append(bb)
            keep.append(j)
        n = len(keep)
        boxes_all[i, :n] = np.asarray(boxes, np.float32).reshape(n, 4)
        cls_all[i, :n] = [c2i[class_names[j]] for j in keep]
        nvalid[i] = n
        images.append(image)
        all_masks.append(masks[keep])
        sizes.append((ih, iw))

    hm = max(im.shape[0] for im in images)
    wm = max(im.shape[1] for im in images)
    img_arr = np.zeros((len(labels), hm, wm, 3), np.uint8)
    msk_arr = np.zeros((len(labels), t, -(-hm * wm // 8)), np.uint8)
    for i, (im, ms) in enumerate(zip(images, all_masks)):
        ih, iw = im.shape[:2]
        img_arr[i, :ih, :iw] = im
        if len(ms):
            padded = np.zeros((len(ms), hm, wm), bool)
            padded[:, :ih, :iw] = ms.astype(bool)
            msk_arr[i, :len(ms)] = np.packbits(
                padded.reshape(len(ms), -1), axis=1)
    return HostCorpus(img_arr, msk_arr, np.asarray(sizes, np.int32),
                      boxes_all, cls_all, nvalid)


def upload_corpus(host: HostCorpus, device=None) -> Dict[str, torch.Tensor]:
    """The pixel arrays on the device, one copy each (from pinned memory
    on CUDA); the per-step path never sends them again.  The packed masks
    become ``mask_words`` there (``_mask_words``)."""
    from dis_yolo_tpu_torch.models.api import resolve_device
    dev = resolve_device(device)
    out = {}
    for key in ("images", "masks_packed", "sizes"):
        t = torch.from_numpy(np.ascontiguousarray(getattr(host, key)))
        if dev.type == "cuda":
            t = t.pin_memory()
        out[key] = t.to(dev)
    hm, wm = host.images.shape[1:3]
    out["mask_words"] = _mask_words(out.pop("masks_packed"), hm, wm)
    return out


def _mask_words(packed: torch.Tensor, hm: int, wm: int) -> torch.Tensor:
    """[N,T,nbytes] u8 packed masks -> [N,Hm,Wm] words whose bit t is
    mask t's pixel (int32 for T <= 32, else int64): one word read gives
    a pixel of every mask.  Built once, at upload."""
    n, t = packed.shape[:2]
    if t > 64:
        raise ValueError(f"at most 64 masks per image, got {t}")
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    words = torch.zeros((n, hm * wm), device=packed.device,
                        dtype=torch.int32 if t <= 32 else torch.int64)
    for i in range(t):
        bits = (packed[:, i, :, None] >> shifts) & 1
        words |= bits.reshape(n, -1)[:, :hm * wm].to(words.dtype) << i
    return words.reshape(n, hm, wm)


# --------------------------------------------------------------------------
# host side of the per-step path: decisions only
# --------------------------------------------------------------------------

class CorpusTrainData(DefectTrainData):
    """Loader of per-example placement decisions instead of pixels.

    The shuffle, cursor, epochs and prefetch thread are
    ``DefectTrainData``'s, and the placement draws are the shared
    ``sample_placement``, so under one seed a corpus run visits the same
    examples with the same placements as the wire loader.  Batches:
    idx [B] int32 (corpus row), place [B,4] int32 (new_h, new_w, dy,
    dx), true_box_px [B,T,5] (placed, clamped boxes in net pixels),
    true_box [B,T,5] (the same normalized on the host, as the wire
    loader's), nvalid [B] int32.
    """

    def __init__(self, cfg: DISYoloConfig, phase: str = "train",
                 seed: int = 0, prefetch: int = 2,
                 labels: Optional[List[Dict]] = None,
                 corpus: Optional[HostCorpus] = None):
        if not cfg.device_side_augs:
            raise ValueError("device_corpus requires cfg.device_side_augs="
                             "True: the host no longer holds pixels, so "
                             "flips and photometric run in the train step")
        super().__init__(cfg, phase, seed=seed, prefetch=prefetch,
                         labels=labels, host_augs=False)
        self.corpus = corpus if corpus is not None else \
            build_host_corpus(cfg, phase, labels=self.gt_labels)

    def _example(self) -> Dict[str, np.ndarray]:
        row = int(self.order[self.cursor])
        self.cursor += 1
        if self.cursor >= len(self.gt_labels):
            self.cursor = 0
            self.epoch += 1
            self.order = self.rng.permutation(len(self.gt_labels))
        net = self.cfg.image_size
        c = self.corpus
        ih, iw = int(c.sizes[row, 0]), int(c.sizes[row, 1])
        n = int(c.nvalid[row])
        boxes = c.boxes[row, :n]
        _, new_w, new_h, dx, dy = sample_placement(self.rng, iw, ih, net,
                                                   boxes)
        tb_px, _ = boxes_to_net(boxes, c.classids[row, :n],
                                self.cfg.max_box_per_image,
                                new_w, new_h, dx, dy, iw, ih, net)
        # normalized on the host, as the wire loader does (a device
        # reciprocal could differ in the last bit)
        tb_norm = tb_px.copy()
        tb_norm[:, :4] /= net
        return dict(idx=np.int32(row),
                    place=np.asarray([new_h, new_w, dy, dx], np.int32),
                    true_box_px=tb_px, true_box=tb_norm, nvalid=np.int32(n))

    def _make_batch(self) -> Dict[str, np.ndarray]:
        exs = [self._example() for _ in range(self.cfg.batch_size)]
        return {k: np.stack([e[k] for e in exs]) for k in exs[0]}


# --------------------------------------------------------------------------
# device side: assemble one batch from the resident corpus
# --------------------------------------------------------------------------

def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as the fused multiply-add
    XLA's fusion makes of JAX's ``a * b + c`` (the float64 product of two
    float32 values is exact)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def _taps(ih, iw, new_h, new_w, dy, dx, size: int):
    """``augment.place_and_pad``'s bilinear taps per image, for a resize
    of ``src[b, :ih, :iw]`` to (new_h, new_w) placed at (dx, dy) on a
    ``size``^2 canvas (all [B] integers): (y0, y1, wy, x0, x1, wx,
    valid), rows and weights [B,size] (y0/y1/x0/x1 int64, wy/wx f32) and
    the canvas pixels inside the placed image [B,size,size].  OpenCV's
    pixel centers (align-corners false), edge-clamped taps, float32, the
    coordinate multiply-adds fused (``_fma``) as in JAX's jitted form."""
    dev = ih.device
    ar = torch.arange(size, dtype=torch.float32, device=dev)
    ry = ar - dy[:, None].float()                      # resized-row coord
    rx = ar - dx[:, None].float()
    fh = ih.float() / new_h.float()
    fw = iw.float() / new_w.float()
    sy = _fma(ry + 0.5, fh[:, None], -0.5)
    sx = _fma(rx + 0.5, fw[:, None], -0.5)
    ih1 = (ih - 1)[:, None]
    iw1 = (iw - 1)[:, None]
    y0 = torch.minimum(torch.clamp_min(torch.floor(sy), 0),
                       ih1.float()).long()
    x0 = torch.minimum(torch.clamp_min(torch.floor(sx), 0),
                       iw1.float()).long()
    y1 = torch.minimum(y0 + 1, ih1)
    x1 = torch.minimum(x0 + 1, iw1)
    wy = torch.clamp(sy - y0, 0.0, 1.0)
    wx = torch.clamp(sx - x0, 0.0, 1.0)
    valid = ((ry >= 0) & (ry < new_h[:, None].float()))[:, :, None] \
        & ((rx >= 0) & (rx < new_w[:, None].float()))[:, None, :]
    return y0, y1, wy, x0, x1, wx, valid


def _resize_place(src: torch.Tensor, taps, pad_value: float
                  ) -> torch.Tensor:
    """``augment.place_and_pad`` per image on ``_taps``: the bilinear
    resize placed on a canvas of ``pad_value``, the multiply-adds fused
    (``_fma``): the result equals JAX's bit for bit.  src [B,Hm,Wm,C]
    (any dtype).  Returns [B,size,size,C] f32."""
    y0, y1, wy, x0, x1, wx, valid = taps
    size = valid.shape[1]
    dev = src.device
    wy = wy[:, :, None, None]
    wx = wx[:, None, :, None]
    bi = torch.arange(src.shape[0], device=dev)[:, None]
    rows = _fma(src[bi, y0].float(), 1.0 - wy, src[bi, y1].float() * wy)
    bi = bi[:, :, None]
    yi = torch.arange(size, device=dev)[None, :, None]
    out = _fma(rows[bi, yi, x0[:, None, :]], 1.0 - wx,
               rows[bi, yi, x1[:, None, :]] * wx)          # [B,size,size,C]
    return torch.where(valid[..., None], out, pad_value)


def _place_masks(words: torch.Tensor, t: int, taps) -> torch.Tensor:
    """``_resize_place`` of 0/1 masks and ``round`` to bool, on the masks'
    ``_mask_words`` [B,Hm,Wm] (t masks).  Returns [B,t,size,size] bool,
    equal to ``round(_resize_place(masks, taps, 0.0)) != 0``.

    A placed pixel's value depends only on its four taps' bits and its
    weights, so each canvas pixel gets a 16-entry table: entry ``4l + r``
    is the rounded value for the left column's (top, bottom) bits ``l``
    and the right column's ``r``, computed with ``_resize_place``'s fused
    multiply-adds on 0/1 inputs.  The four taps' words then give, for
    each entry, the word of the masks whose taps read it (no mask reads
    two), and the entries the table sets are summed into the pixel's
    word of placed masks.
    """
    y0, y1, wy, x0, x1, wx, valid = taps
    size = valid.shape[1]
    dev = words.device
    b = words.shape[0]
    code = torch.arange(4, device=dev)
    top, bottom = (code & 1).float(), (code >> 1).float()
    rv = _fma(top, 1.0 - wy[..., None], bottom * wy[..., None])  # [B,S,4]
    wx = wx[:, None, :, None, None]
    out = _fma(rv[:, :, None, :, None], 1.0 - wx,
               rv[:, :, None, None, :] * wx)               # [B,S,S,4,4]
    table = (torch.round(out) != 0).reshape(b, size, size, 16) \
        & valid[..., None]

    bi = torch.arange(b, device=dev)[:, None, None]
    entry = torch.arange(16, device=dev)
    placed = None
    # the taps (y0,x0), (y1,x0), (y0,x1), (y1,x1) are bits 2, 3, 0, 1 of
    # an entry: a mask reads entry e where each tap's bit is e's
    for ys, xs, shift in ((y0, x0, 2), (y1, x0, 3), (y0, x1, 0), (y1, x1, 1)):
        w = words[bi, ys[:, :, None], xs[:, None, :]][..., None]  # [B,S,S,1]
        flip = ((entry >> shift) & 1).to(words.dtype) - 1         # 0 or ~0
        hit = w ^ flip
        placed = hit if placed is None else placed & hit          # [B,S,S,16]
    placed = (placed * table).sum(-1, dtype=words.dtype)          # disjoint
    ti = torch.arange(t, device=dev, dtype=words.dtype)[None, :, None, None]
    return ((placed[:, None] >> ti) & 1).bool()


def _grids(tb_px: torch.Tensor, tb_val: torch.Tensor, nvalid: torch.Tensor,
           anchors: torch.Tensor, g: int, a: int, c: int, net: float
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``dataset.assign_anchors`` per image, batched.

    tb_px [B,T,5] = placed, clamped (cx, cy, w, h, class) in net pixels
    drives the anchor IoU and the cell indices; tb_val [B,T,5] holds the
    coordinate values written (the host-normalized boxes).  Best anchor
    by wh-IoU (first maximum), a box whose cell an earlier live box took
    loses, a box with no IoU > 0 is dropped.  Rows that are not written
    go to a spare grid row, sliced off: the live cells are unique, so
    the scatter is deterministic.
    """
    b, t = tb_px.shape[:2]
    dev = tb_px.device
    wh = tb_px[..., 2:4]
    inter = (torch.minimum(wh[..., None, 0], anchors[:, 0])
             * torch.minimum(wh[..., None, 1], anchors[:, 1]))   # [B,T,9]
    union = wh[..., 0:1] * wh[..., 1:2] + anchors[:, 0] * anchors[:, 1] \
        - inter
    iou = inter / union
    best = torch.argmax(iou, -1)
    best_iou = torch.gather(iou, -1, best[..., None])[..., 0]
    live = (torch.arange(t, device=dev) < nvalid[:, None]) & (best_iou > 0)
    scale = best // a
    ai = best % a
    m_of = (torch.full_like(scale, 4 * g) >> scale).float()   # 4g, 2g, g
    # a divisor tensor: a Python-scalar divisor is a multiply by its
    # reciprocal on CUDA, which could move a box across a cell edge
    net_t = torch.full((), net, dtype=torch.float32, device=dev)
    x_ind = (tb_px[..., 0] * m_of / net_t).long()        # truncation
    y_ind = (tb_px[..., 1] * m_of / net_t).long()
    # first wins: box n loses to an earlier live box on the same
    # (scale, y, x, anchor) cell
    code = ((scale * (4 * g) + y_ind) * (4 * g) + x_ind) * a + ai
    same = (code[:, None, :] == code[:, :, None]) & live[:, None, :]
    earlier = torch.ones((t, t), dtype=torch.bool, device=dev).tril(-1)
    win = live & ~(same & earlier).any(-1)

    onehot = (tb_px[..., 4].long()[..., None]
              == torch.arange(c, device=dev)).float()
    rows = torch.cat([tb_val[..., :4], torch.ones_like(tb_val[..., :1]),
                      onehot], -1)                          # [B,T,5+c]
    bi = torch.arange(b, device=dev)[:, None].expand(b, t)
    grids = []
    for s, m in enumerate((4 * g, 2 * g, g)):
        grid = torch.zeros((b, m + 1, m, a, 5 + c), dtype=torch.float32,
                           device=dev)
        sel = win & (scale == s)
        ys = torch.where(sel, y_ind, m)                    # m: the spare row
        xs = torch.where(sel, x_ind, 0)
        grid[bi, ys, xs, ai] = rows
        grids.append(grid[:, :m].contiguous())
    return tuple(grids)


def make_assemble_fn(cfg: DISYoloConfig):
    """``assemble(corpus, params) -> batch``.

    corpus: ``upload_corpus``'s tensors.  params: a ``CorpusTrainData``
    batch as tensors on the corpus's device.  Returns the standard
    7-field batch: images uint8 [B,S,S,3], true_masks bool [B,T,S,S],
    true_boxes [B,1,1,1,T,5] (normalized), labels_s8 / s16 / s32,
    windows [B,4].
    """
    size = cfg.image_size
    g, a, c = cfg.base_grid, cfg.anchors_per_scale, cfg.num_class
    net = float(size)
    anchors_np = np.asarray(cfg.anchors_array(), np.float32)
    anchors_on = {}       # per device, copied once: no host copy per step

    def assemble(corpus: Dict[str, torch.Tensor],
                 p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        idx = p["idx"].long()
        dev = idx.device
        imgs = corpus["images"][idx]                   # [B,Hm,Wm,3] u8
        words = corpus["mask_words"][idx]              # [B,Hm,Wm]
        hws = corpus["sizes"][idx].long()
        ih, iw = hws[:, 0], hws[:, 1]
        new_h, new_w, dy, dx = p["place"].long().unbind(-1)
        taps = _taps(ih, iw, new_h, new_w, dy, dx, size)
        canvas = _resize_place(imgs, taps, 127.0)
        images = torch.clamp(torch.round(canvas), 0, 255).to(torch.uint8)
        true_masks = _place_masks(words, cfg.max_box_per_image, taps)

        if dev not in anchors_on:
            anchors_on[dev] = torch.as_tensor(anchors_np, device=dev)
        grids = _grids(p["true_box_px"], p["true_box"], p["nvalid"],
                       anchors_on[dev], g, a, c, net)
        windows = torch.zeros((idx.shape[0], 4), device=dev)
        windows[:, 2:] = 1.0
        return dict(
            images=images, true_masks=true_masks,
            true_boxes=p["true_box"][:, None, None, None],
            labels_s8=grids[0], labels_s16=grids[1], labels_s32=grids[2],
            windows=windows)

    return assemble

"""Training data: labels, rasterization cache, augmentation, anchor
assignment, batched prefetch (the counterpart of
``dis_yolo_tpu/data/dataset.py``).

numpy only, no OpenCV: images come through ``data.image_io.read_image``
(binary PPM in numpy, anything else through OpenCV where it imports),
polygons through ``data.rasterize``'s native engine, and the
augmentation through ``data.augment``, which computes what the JAX
package's OpenCV calls compute.  The same labels, seed and split give
the JAX package's batches: the labels, grids and masks exactly, the
pixels within the bounds ``data.augment`` states.

Batch layout (the reference 7-tuple, compact wire format; the train step
expands it on the device, ``train_step.prepare_batch``):
  images       [B, S, S, 3] uint8
  masks_packed [B, T, S*S/8] uint8  (np.packbits rows of the masks)
  true_boxes   [B, 1, 1, 1, T, 5]  normalized (xc, yc, w, h, classid)
  labels_s8    [B, 4g, 4g, A, 5+C]
  labels_s16   [B, 2g, 2g, A, 5+C]
  labels_s32   [B,  g,  g, A, 5+C]
  windows      [B, 4] = (0, 0, 1, 1) during training

Nothing here imports torch, so the worker processes of
``ParallelTrainData`` start light.
"""

from __future__ import annotations

import collections
import multiprocessing
import os
import pickle
import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data import augment, rasterize
from dis_yolo_tpu_torch.data.image_io import read_image

# the loader's polygon fill (data/rasterize.py ENGINES), read at each
# call; "native" builds native/datapath.cc with g++ at first use and
# raises if it cannot (tests set "numpy" to run the oracle)
FILL_ENGINE = "native"
# the longest stop() waits for each of the prefetch thread and the pool
STOP_TIMEOUT_S = 5.0


# --------------------------------------------------------------------------
# label loading
# --------------------------------------------------------------------------

def load_labels(cfg: DISYoloConfig, phase: str) -> List[Dict]:
    """gt_labels list [{'imname', 'class_names', 'polygons'}, ...], with
    the derived cache ``cache/gt_labels_<phase>.pkl``."""
    split_dir = cfg.data_path(phase)
    cache_dir = os.path.join(split_dir, "cache")
    derived = os.path.join(cache_dir, f"gt_labels_{phase}.pkl")
    if os.path.isfile(derived):
        with open(derived, "rb") as f:
            return pickle.load(f)

    with open(os.path.join(cache_dir, "ground_truth_cache.pkl"), "rb") as f:
        annotations = pickle.load(f)
    annotations = [a for a in annotations if a["regions"]]

    with open(os.path.join(cache_dir, f"{phase}.txt")) as f:
        index = [x.strip() for x in f.readlines()]
    assert len(index) == len(annotations)

    gt_labels = []
    for i, stem in enumerate(index):
        a = annotations[i]
        assert os.path.splitext(a["filename"])[0] == stem
        regions = a["regions"]
        gt_labels.append({
            "imname": os.path.join(split_dir, "images", a["filename"]),
            "class_names": [r["region_attributes"] for r in regions.values()],
            "polygons": [r["shape_attributes"] for r in regions.values()],
        })
    os.makedirs(cache_dir, exist_ok=True)
    with open(derived, "wb") as f:
        pickle.dump(gt_labels, f)
    return gt_labels


# --------------------------------------------------------------------------
# host caches
# --------------------------------------------------------------------------

class MaskCache:
    """LRU of bit-packed rasterized instance masks keyed by image name."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._store: Dict[str, Tuple] = {}
        self._order: List[str] = []
        self._lock = threading.Lock()

    def get(self, key: str):
        with self._lock:
            if key in self._store:
                self._order.remove(key)
                self._order.append(key)
                packed, shape, n = self._store[key]
                masks = np.unpackbits(packed, count=n * shape[0] * shape[1])
                return masks.reshape(n, *shape).astype(bool)
            return None

    def put(self, key: str, masks: np.ndarray):
        with self._lock:
            packed = np.packbits(masks.astype(np.uint8))
            self._store[key] = (packed, masks.shape[1:], masks.shape[0])
            self._order.append(key)
            if len(self._order) > self.capacity:
                del self._store[self._order.pop(0)]


class ImageCache:
    """Byte-bounded LRU of decoded RGB uint8 images keyed by path: decode
    is paid once per image, not once per epoch; the same pixels come
    out."""

    def __init__(self, capacity_mb: int = 512):
        self.capacity = capacity_mb * (1 << 20)
        self._store: Dict[str, np.ndarray] = {}
        self._order: List[str] = []
        self._bytes = 0
        self._lock = threading.Lock()

    def load(self, imname: str, read=None) -> np.ndarray:
        with self._lock:
            img = self._store.get(imname)
            if img is not None:
                self._order.remove(imname)
                self._order.append(imname)
                return img
        img = (read or read_image)(imname)
        if img.nbytes <= self.capacity:
            with self._lock:
                if imname not in self._store:
                    self._store[imname] = img
                    self._order.append(imname)
                    self._bytes += img.nbytes
                    while self._bytes > self.capacity:
                        evict = self._order.pop(0)
                        self._bytes -= self._store.pop(evict).nbytes
        return img


# --------------------------------------------------------------------------
# anchor assignment
# --------------------------------------------------------------------------

def assign_anchors(boxes_px: np.ndarray, classids: np.ndarray,
                   cfg: DISYoloConfig) -> List[np.ndarray]:
    """The 3 label grids of one image [labels_s8 (4g), labels_s16 (2g),
    labels_s32 (g)] from boxes_px [N, 4] (xc, yc, w, h in net pixels) and
    classids [N]: each box at its best-IoU anchor's cell, a box whose
    cell is already taken is skipped, one with no anchor IoU > 0 dropped."""
    g, a, c = cfg.base_grid, cfg.anchors_per_scale, cfg.num_class
    net = float(cfg.image_size)
    anchors = cfg.anchors_array()                                   # [9,2]
    grids = [np.zeros((m, m, a, 5 + c), np.float32) for m in (4 * g, 2 * g, g)]

    if len(boxes_px) == 0:
        return grids
    wh = boxes_px[:, 2:4]                                           # [N,2]
    inter = (np.minimum(wh[:, None, 0], anchors[None, :, 0])
             * np.minimum(wh[:, None, 1], anchors[None, :, 1]))     # [N,9]
    union = wh[:, 0:1] * wh[:, 1:2] + anchors[:, 0] * anchors[:, 1] - inter
    iou = inter / union
    best = np.argmax(iou, axis=1)
    best_iou = iou[np.arange(len(boxes_px)), best]

    for n in range(len(boxes_px)):
        if best_iou[n] <= 0:
            print("No anchor has iou > 0 for this ground-truth box")
            continue
        grid = grids[best[n] // a]
        ai = best[n] % a
        m = grid.shape[0]
        x_ind = int(boxes_px[n, 0] * m / net)
        y_ind = int(boxes_px[n, 1] * m / net)
        if grid[y_ind, x_ind, ai, 4] == 1:                          # occupied
            continue
        grid[y_ind, x_ind, ai, 0:4] = boxes_px[n, :4]
        grid[y_ind, x_ind, ai, 4] = 1.0
        grid[y_ind, x_ind, ai, 5 + int(classids[n])] = 1.0
    return grids


def _flip_grid(grid: np.ndarray, axis: int, net: float) -> np.ndarray:
    """Flip a label grid and fix the flipped center coordinate (pixels)."""
    grid = grid[::-1, :, :, :] if axis == 0 else grid[:, ::-1, :, :]
    grid = grid.copy()
    coord = 1 if axis == 0 else 0     # cy for vertical flip, cx for horizontal
    obj = grid[..., 4] == 1
    grid[..., coord] = np.where(obj, net - 1 - grid[..., coord], grid[..., coord])
    return grid


# --------------------------------------------------------------------------
# one example: a pure function of (cfg, label, rng)
# --------------------------------------------------------------------------

def sample_placement(rng: np.random.RandomState, iw: int, ih: int, net: int,
                     boxes: np.ndarray) -> Tuple[int, int, int, int, int]:
    """Draw one example's scale/crop placement: the coin, then (flag 2)
    the jitter uniforms; a placement that would cut a GT box (boxes
    [N, 4] x1y1x2y2 pixels) falls back to the centered letterbox."""
    sc, new_w, new_h, dx, dy = augment.sample_scale_crop(rng, iw, ih, net, net)
    if sc == 2 and len(boxes):
        sx, sy = new_w / iw, new_h / ih
        x1 = boxes[:, 0] * sx + dx
        y1 = boxes[:, 1] * sy + dy
        x2 = boxes[:, 2] * sx + dx
        y2 = boxes[:, 3] * sy + dy
        if (x1.min() < 0 or y1.min() < 0 or
                x2.max() >= net or y2.max() >= net):
            sc = 1
            new_w, new_h, dx, dy = augment.identity_placement(iw, ih, net, net)
    return sc, new_w, new_h, dx, dy


def boxes_to_net(boxes: np.ndarray, classids: np.ndarray, t: int,
                 new_w: int, new_h: int, dx: int, dy: int, iw: int, ih: int,
                 net: int) -> Tuple[np.ndarray, np.ndarray]:
    """Placed and clamped (cx, cy, w, h) boxes in net pixels.  Returns
    (true_box [t, 5], boxes_net [n, 4])."""
    sx, sy = new_w / iw, new_h / ih
    tb = np.zeros((t, 5), np.float32)
    boxes_net = np.zeros((len(boxes), 4), np.float32)
    for n in range(len(boxes)):
        x1 = max(min(boxes[n, 0] * sx + dx, net - 1), 0)
        y1 = max(min(boxes[n, 1] * sy + dy, net - 1), 0)
        x2 = max(min(boxes[n, 2] * sx + dx, net - 1), 0)
        y2 = max(min(boxes[n, 3] * sy + dy, net - 1), 0)
        boxes_net[n] = [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1]
        tb[n, :4] = boxes_net[n]
        tb[n, 4] = classids[n]
    return tb, boxes_net


def build_example(cfg: DISYoloConfig, label: Dict,
                  rng: np.random.RandomState, host_augs: bool,
                  mask_cache: Optional[MaskCache] = None,
                  load_image=read_image) -> Dict[str, np.ndarray]:
    """One augmented training example (image_u8 [S,S,3], masks_packed
    [T, S*S/8], true_box [T,5], grids).  All randomness comes from
    ``rng``, drawn in the JAX package's order: placement, flip,
    photometric choice, then the photometric draws."""
    net = cfg.image_size
    t = cfg.max_box_per_image
    c2i = cfg.class_to_ind()

    image = load_image(label["imname"])
    ih, iw = image.shape[:2]
    class_names = label["class_names"][:t]
    if len(label["polygons"]) > t:
        print(f"More than {t} instances in {label['imname']}")

    masks = None
    if mask_cache is not None:
        key = f"{id(label)}:{label['imname']}"
        cached = mask_cache.get(key)
        if cached is not None and cached.shape[1:] == (ih, iw):
            masks = cached
    if masks is None:
        polys = label["polygons"][:t]
        masks = rasterize.instance_masks(polys, ih, iw, len(polys),
                                         FILL_ENGINE)
        if mask_cache is not None:
            mask_cache.put(key, masks)

    boxes, keep = [], []
    for i in range(masks.shape[0]):
        bb = rasterize.mask_to_box(masks[i])
        if bb is None:
            continue
        boxes.append(bb)
        keep.append(i)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)       # x1y1x2y2 px
    classids = np.asarray([c2i[class_names[i]] for i in keep], np.int64)
    masks = masks[keep]

    # aug 1: random scale/crop, rejected if any box gets cut
    sc, new_w, new_h, dx, dy = sample_placement(rng, iw, ih, net, boxes)
    tb, boxes_net = boxes_to_net(boxes, classids, t, new_w, new_h, dx, dy,
                                 iw, ih, net)
    grids = assign_anchors(boxes_net, classids, cfg)

    # aug 2: random horizontal / vertical flip
    flip = rng.randint(1, 4) if (cfg.flipped and host_augs) else 1
    if flip == 2:
        tb[: len(boxes), 0] = net - 1 - tb[: len(boxes), 0]
        grids = [_flip_grid(g, 1, net) for g in grids]
    elif flip == 3:
        tb[: len(boxes), 1] = net - 1 - tb[: len(boxes), 1]
        grids = [_flip_grid(g, 0, net) for g in grids]

    # aug 3: photometric, in the reference's code order
    bnl = rng.randint(1, 5) if (cfg.blur_noise_light and host_augs) else 1

    img_net = augment.place_and_pad(image, new_w, new_h, dx, dy,
                                    net, net, pad_value=127)
    if flip == 2:
        img_net = img_net[:, ::-1, :]
    elif flip == 3:
        img_net = img_net[::-1, :, :]
    img_net = augment.apply_photometric(
        np.ascontiguousarray(img_net).astype(np.uint8), bnl, rng)

    # masks -> net canvas, flipped, bit-packed
    n = len(boxes)
    packed = np.zeros((t, net * net // 8), np.uint8)
    if n:
        out_masks = np.empty((n, net, net), bool)
        for i in range(n):
            m = augment.place_and_pad(masks[i].astype(np.float32),
                                      new_w, new_h, dx, dy, net, net, 0.0)
            if flip == 2:
                m = m[:, ::-1, :]
            elif flip == 3:
                m = m[::-1, :, :]
            out_masks[i] = np.around(m[:, :, 0]).astype(bool)
        packed[:n] = np.packbits(out_masks.reshape(n, -1), axis=1)

    # normalized coordinates
    tb[:, :4] /= net
    for g in grids:
        g[..., 0:4] /= net
    return dict(image_u8=img_net, masks_packed=packed,
                true_box=tb, grids=grids)


def collate(exs: List[Dict[str, np.ndarray]],
            cfg: DISYoloConfig) -> Dict[str, np.ndarray]:
    """Stack example dicts into the compact 7-tuple layout (module doc)."""
    b = len(exs)
    return dict(
        images=np.stack([e["image_u8"] for e in exs]),
        masks_packed=np.stack([e["masks_packed"] for e in exs]),
        true_boxes=np.stack([e["true_box"] for e in exs])[:, None, None, None],
        labels_s8=np.stack([e["grids"][0] for e in exs]),
        labels_s16=np.stack([e["grids"][1] for e in exs]),
        labels_s32=np.stack([e["grids"][2] for e in exs]),
        windows=np.tile(np.asarray([0., 0., 1., 1.], np.float32), (b, 1)),
    )


def expand_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Host inverse of the compact format (f32 images + bool masks), what
    ``train_step.prepare_batch`` computes on the device; a no-op on an
    expanded batch."""
    batch = dict(batch)
    if batch["images"].dtype == np.uint8:
        batch["images"] = batch["images"].astype(np.float32) / 255.0
    if "masks_packed" in batch:
        packed = batch.pop("masks_packed")
        b, t = packed.shape[:2]
        s = batch["images"].shape[1]
        bits = np.unpackbits(packed, axis=-1, count=s * s)
        batch["true_masks"] = bits.reshape(b, t, s, s).astype(bool)
    return batch


# --------------------------------------------------------------------------
# the loader
# --------------------------------------------------------------------------

class DefectTrainData:
    """Epoch-shuffled batched training loader with a background prefetch
    thread; one ``RandomState(seed)`` stream drives the shuffle and every
    example's augmentation, as in the JAX package."""

    def __init__(self, cfg: DISYoloConfig, phase: str = "train",
                 seed: int = 0, prefetch: int = 2,
                 labels: Optional[List[Dict]] = None,
                 host_augs: bool = True):
        self.cfg = cfg
        self.phase = phase
        self.host_augs = host_augs
        self.rng = np.random.RandomState(seed)
        self.gt_labels = labels if labels is not None else load_labels(cfg, phase)
        self.order = self.rng.permutation(len(self.gt_labels))
        self.cursor = 0
        self.epoch = 1
        self.mask_cache = MaskCache()
        self.image_cache = ImageCache()
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None

    def _example(self) -> Dict[str, np.ndarray]:
        label = self.gt_labels[self.order[self.cursor]]
        self.cursor += 1
        if self.cursor >= len(self.gt_labels):
            self.cursor = 0
            self.epoch += 1
            self.order = self.rng.permutation(len(self.gt_labels))
        return build_example(self.cfg, label, self.rng, self.host_augs,
                             self.mask_cache, self.image_cache.load)

    def _make_batch(self) -> Dict[str, np.ndarray]:
        return collate([self._example() for _ in range(self.cfg.batch_size)],
                       self.cfg)

    def get(self) -> Dict[str, np.ndarray]:
        """Next batch (synchronous)."""
        return self._make_batch()

    def _put(self, batch) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(batch, timeout=0.5)
                return
            except queue.Full:
                continue

    def _run(self, produce) -> None:
        """The prefetch thread's body; an error ends it and is raised by
        the next ``next_prefetched``."""
        try:
            while not self._stop.is_set():
                self._put(produce())
        except _Stopped:
            pass
        except Exception as e:          # handed to the consumer
            self._error = e

    def start_prefetch(self):
        """Start the prefetch thread (again after a ``stop``)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._error = None
        self._thread = threading.Thread(target=self._run,
                                        args=(self._make_batch,), daemon=True)
        self._thread.start()

    def next_prefetched(self) -> Dict[str, np.ndarray]:
        """Next batch from the prefetch thread (synchronous without it)."""
        if self._thread is None:
            return self.get()
        while True:
            try:
                return self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError("the training loader's prefetch "
                                       "failed") from self._error
                if not self._thread.is_alive():
                    raise RuntimeError("the training loader's prefetch "
                                       "thread is gone")

    def stop(self):
        """Stop prefetching; returns within ``STOP_TIMEOUT_S``."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(STOP_TIMEOUT_S)


# --------------------------------------------------------------------------
# multiprocess loader
# --------------------------------------------------------------------------
#
# ParallelTrainData fans examples out over a pool of worker processes and
# stays deterministic for any pool width:
#
#   * the epoch shuffle comes from the order RNG (seeded ``seed``),
#     advanced only on the side that issues the tasks, and
#   * example number g (a global counter) draws all its augmentation
#     randomness from its own RandomState seeded by SeedSequence([seed, g]),
#
# so every width (the inline workers=0 included) gives bit-identical
# batches.  This replaces, rather than reproduces, DefectTrainData's
# single stream.
#
# The pool uses the "spawn" start method: the parent has usually
# initialized CUDA, and a fork after that is unsafe.  A worker holds only
# numpy, the config and the labels.  stop() is bounded: the prefetch
# thread waits on each result with a timeout, so it sees the stop flag,
# and the pool's terminate + join run on a helper thread joined with a
# timeout.

_W_STATE: Dict = {}


def _pool_init(cfg, labels, host_augs, seed):
    _W_STATE.update(cfg=cfg, labels=labels, host_augs=host_augs, seed=seed,
                    cache=MaskCache(), images=ImageCache())


def _example_rng(seed: int, g: int) -> np.random.RandomState:
    return np.random.RandomState(
        np.random.SeedSequence([seed, g]).generate_state(4))


def _pool_example(task):
    label_idx, g = task
    st = _W_STATE
    return build_example(st["cfg"], st["labels"][label_idx],
                         _example_rng(st["seed"], g), st["host_augs"],
                         st["cache"], st["images"].load)


class ParallelTrainData(DefectTrainData):
    """Worker-pool training loader, deterministic for any worker count.

    ``workers=0`` assembles examples inline with the same per-example RNG
    scheme (the reference stream for the parity checks); ``workers=None``
    uses every host core.  ``host_shard=(process_index, process_count)``
    makes this host build only its rows of each global batch
    (``cfg.batch_size`` is the global size): global batch t row r is
    example g = t*B + r, and host p owns rows [p*B/n, (p+1)*B/n), so the
    hosts' batches concatenated in process order are the unsharded
    stream.
    """

    def __init__(self, cfg: DISYoloConfig, phase: str = "train",
                 seed: int = 0, prefetch: int = 4,
                 labels: Optional[List[Dict]] = None,
                 host_augs: bool = True, workers: Optional[int] = None,
                 host_shard: Optional[Tuple[int, int]] = None):
        super().__init__(cfg, phase, seed=seed, prefetch=prefetch,
                         labels=labels, host_augs=host_augs)
        self.seed = seed
        self.workers = (os.cpu_count() or 1) if workers is None else workers
        if host_shard is not None:
            pid, n = host_shard
            assert 0 <= pid < n and cfg.batch_size % n == 0, (host_shard,
                                                              cfg.batch_size)
        self.host_shard = host_shard
        self._g = 0
        self._pool = None

    def _local_batch(self) -> int:
        if self.host_shard is None:
            return self.cfg.batch_size
        return self.cfg.batch_size // self.host_shard[1]

    def _owns(self, g: int) -> bool:
        if self.host_shard is None:
            return True
        pid, n = self.host_shard
        per = self.cfg.batch_size // n
        return (g % self.cfg.batch_size) // per == pid

    def _next_task(self) -> Tuple[int, int]:
        """Next owned (label_idx, g); the shuffle and the example counter
        advance through skipped rows, so every host sees the same global
        order."""
        while True:
            label_idx = int(self.order[self.cursor])
            self.cursor += 1
            if self.cursor >= len(self.gt_labels):
                self.cursor = 0
                self.epoch += 1
                self.order = self.rng.permutation(len(self.gt_labels))
            g = self._g
            self._g += 1
            if self._owns(g):
                return label_idx, g

    def _example(self) -> Dict[str, np.ndarray]:
        label_idx, g = self._next_task()
        return build_example(self.cfg, self.gt_labels[label_idx],
                             _example_rng(self.seed, g), self.host_augs,
                             self.mask_cache, self.image_cache.load)

    def _make_batch(self) -> Dict[str, np.ndarray]:
        return collate([self._example() for _ in range(self._local_batch())],
                       self.cfg)

    def start_prefetch(self):
        if self._thread is not None:
            return
        if self.workers == 0:
            return super().start_prefetch()
        if FILL_ENGINE == "native":
            from dis_yolo_tpu_torch import native
            native.build()          # once here, not in every worker
        self._stop.clear()
        self._error = None
        ctx = multiprocessing.get_context("spawn")
        pool = ctx.Pool(self.workers, initializer=_pool_init,
                        initargs=(self.cfg, self.gt_labels, self.host_augs,
                                  self.seed))
        self._pool = pool
        in_flight: collections.deque = collections.deque()
        depth = 2 * self.workers
        b = self._local_batch()

        def produce():
            examples = []
            while len(examples) < b:
                while len(in_flight) < depth:
                    in_flight.append(pool.apply_async(_pool_example,
                                                      (self._next_task(),)))
                head = in_flight[0]
                while not self._stop.is_set():
                    try:
                        examples.append(head.get(timeout=0.5))
                        break
                    except multiprocessing.TimeoutError:
                        continue
                else:
                    raise _Stopped()
                in_flight.popleft()
            return collate(examples, self.cfg)

        self._thread = threading.Thread(target=self._run, args=(produce,),
                                        daemon=True)
        self._thread.start()

    def stop(self):
        """Stop prefetching and the pool; returns within about
        2 x ``STOP_TIMEOUT_S``, whatever state the pool is in."""
        super().stop()
        pool, self._pool = self._pool, None
        if pool is not None:
            def shut():
                pool.terminate()
                pool.join()
            closer = threading.Thread(target=shut, daemon=True)
            closer.start()
            closer.join(STOP_TIMEOUT_S)


class _Stopped(Exception):
    """Ends the pool's prefetch thread when ``stop`` is called."""

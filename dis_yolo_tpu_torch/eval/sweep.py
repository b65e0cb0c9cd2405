"""The detection sweep over a whole split, for validation and test
evaluation (the counterpart of ``dis_yolo_tpu/eval/sweep.py``).

``run_split`` predicts a letterboxed split batch by batch and hands the
results to ``eval.map_eval.Evaluator.evaluate_detections`` in one of
three forms, by route:

  * host (the default): ``predict`` on the card, the raw [D,S,S] masks
    fetched; the host crops, resizes and pastes them
    (``eval.postprocess.detections_to_original``);
  * ``device_paste``: the paste runs on the card, grouped by original
    image size, and the full-resolution masks come back bit-packed
    (``ops.paste.pack_mask_bits``), with the semantic map when asked;
  * ``device_score``: the paste and the det-vs-GT mask IoU matrix (and,
    with ``gt_semantic``, the confusion totals) run on the card; only
    boxes, validity and the IoU rows come back.  The ground truth is
    uploaded once into ``paste_cache`` and reused by later sweeps, and
    the split's images stay on the card, each batch gathered there.

Every batch has ``cfg.batch_size`` images: the tail batch is padded.
At most two batches are in flight: batch t + 1 is launched before
batch t's results are waited for.  The returned predict seconds run from the
first batch to the last fetched result, the copies to the host included
(each batch's copies are waited for through a CUDA event); the warm-up
calls are outside that window.  In the ``device_score`` route the
scoring is inside the predict seconds, in the other two it lands in the
evaluator's ``t_post_s``: compare routes by their totals.

Everything runs on ``device`` (default ``cuda``; ``device="cpu"`` runs
the plain PyTorch path on the CPU).  The paste's float32 products refuse
TF32 on CUDA (``ops.paste``), and this module leaves that check on.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.ops import paste

_FULL_WINDOW = (0.0, 0.0, 1.0, 1.0)


def _pad_windows(b: int, wins: np.ndarray) -> np.ndarray:
    """Pad a tail batch's windows to ``b`` rows with full windows."""
    pad = b - wins.shape[0]
    return np.concatenate([wins, np.tile(_FULL_WINDOW, (pad, 1))
                           .astype(np.float32)]) if pad else wins


def _pad_batch(b: int, imgs: np.ndarray, wins: np.ndarray):
    """Pad a tail batch to ``b`` images (zero images, full windows)."""
    pad = b - imgs.shape[0]
    if pad:
        imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:],
                                              imgs.dtype)])
    return imgs, _pad_windows(b, wins)


def _start_fetch(outs, dev: torch.device):
    """Start copying ``outs`` to the host: on CUDA into pinned memory
    without blocking, with an event recorded after the copies."""
    if dev.type != "cuda":
        return list(outs), None
    host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            for x in outs]
    for h, x in zip(host, outs):
        h.copy_(x, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _finish_fetch(handle, timing: Optional[Dict[str, float]]):
    """Wait for ``_start_fetch``'s copies; numpy arrays of the outputs."""
    host, event = handle
    t0 = time.time()
    if event is not None:
        event.synchronize()
    arrays = [h.numpy() for h in host]
    if timing is not None:
        timing["fetch_s"] = timing.get("fetch_s", 0.0) + time.time() - t0
    return arrays


def _pipelined(jobs, launch, collect, dev, timing) -> float:
    """Launch each job, keeping at most two in flight; ``collect`` gets
    each job with its fetched arrays, in order.  Returns the seconds from
    the first launch to the last result."""
    t0 = time.time()
    inflight: List = []
    for job in jobs:
        inflight.append((job, _start_fetch(launch(job), dev)))
        if len(inflight) > 2:
            done, handle = inflight.pop(0)
            collect(done, _finish_fetch(handle, timing))
    for done, handle in inflight:
        collect(done, _finish_fetch(handle, timing))
    return time.time() - t0


def _groups(names: List[str], gt_sizes) -> Dict[Tuple[int, int], List[int]]:
    """Image indices by original size, in first-seen order."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, nm in enumerate(names):
        groups.setdefault(tuple(gt_sizes[nm]), []).append(i)
    return groups


def _device_gt(gt_records: Dict[str, List[Dict]], names: List[str],
               h0: int, w0: int, idxs: List[int], dev: torch.device):
    """One size group's GT instance masks, bit-packed, on ``dev``:
    (packed uint8 [N,G,H,ceil(W/8)], areas float32 [N,G], row of each
    name).  Instances keep ``Evaluator.gt_masks``'s order per image,
    the order ``voc_eval`` builds its per-class records in, so a class's
    IoU columns are that class's slice of the row."""
    g_max = max(1, max(len(gt_records[names[i]]) for i in idxs))
    packed = np.zeros((len(idxs), g_max, h0, -(-w0 // 8)), np.uint8)
    areas = np.zeros((len(idxs), g_max), np.float32)
    rows = {}
    for r, i in enumerate(idxs):
        rows[names[i]] = r
        for g, obj in enumerate(gt_records[names[i]]):
            m = obj["mask"]
            assert m.shape == (h0, w0)
            packed[r, g] = np.packbits(m, axis=-1)
            areas[r, g] = float(m.sum(dtype=np.int64))   # exact: < 2^24
    return (torch.from_numpy(packed).to(dev), torch.from_numpy(areas).to(dev),
            rows)


def run_split(cfg: DISYoloConfig, model, images: np.ndarray,
              names: List[str], windows: np.ndarray,
              device_paste: bool = False,
              gt_sizes: Optional[Dict[str, Tuple[int, int]]] = None,
              mesh=None, predict_fn=None,
              paste_cache: Optional[Dict] = None,
              timing: Optional[Dict[str, float]] = None,
              want_semantic: bool = True,
              device_score: bool = False,
              gt_records: Optional[Dict[str, List[Dict]]] = None,
              gt_semantic: Optional[Dict[str, np.ndarray]] = None,
              device=None) -> Tuple[List[Dict], float]:
    """Predict a whole split; returns (detdata, predict_seconds).

    ``images`` [N,S,S,3] float32 and ``windows`` [N,4] are the
    letterboxed split (``data.val_data``), ``names`` its image names;
    ``gt_sizes`` (name -> original (h, w)) is needed by the two device
    routes.  ``predict_fn(images, windows)`` replaces the host route's
    ``api.predict`` (a function with a true ``_warmed`` attribute gets no
    warm-up call).  The device routes call ``api.predict`` with no
    threshold, so ``model.cfg.obj_threshold`` applies.

    ``paste_cache``: a caller-owned dict kept across sweeps (a periodic
    validation): it holds each size group's paste/score function (warmed
    once, when it is built), the uploaded ground truth and the resident
    images.  ``device_score`` needs ``gt_records`` (``Evaluator
    .gt_masks``); with ``gt_semantic`` (``Evaluator.gt_semantic``) its
    entries also carry per-image confusion totals
    (``Evaluator.miou_from_confusions``).  ``timing["fetch_s"]``, when a
    dict is passed, accumulates the time spent waiting for results.
    """
    if mesh is not None:
        raise NotImplementedError(
            "run_split(mesh=...): the data-parallel sweep belongs to the "
            "port's parallel layer, not ported yet (ROADMAP A.7)")
    dev = api.resolve_device(device)
    b = cfg.batch_size
    cache = paste_cache if paste_cache is not None else {}
    by_name: Dict[str, Dict] = {}

    if device_score:
        assert gt_sizes is not None and gt_records is not None
        want_conf = gt_semantic is not None
        n_sem = cfg.num_class + 1

        def make_run_scored(h0, w0):
            def f(imgs, wins, gt_p, gt_a, rows, gt_s=None):
                dets, masks = api.predict(model, imgs, wins, device=dev)
                full, valid = paste.paste_masks_single(masks, dets, h0, w0,
                                                       cfg.test_size)
                iou = paste.mask_iou_batch(full, gt_p[rows], gt_a[rows])
                if gt_s is None:
                    return dets, valid, iou
                sem = paste.merged_semantic_single(full, dets[..., 4], valid)
                conf = paste.semantic_confusion(sem, gt_s[rows], n_sem)
                return dets, valid, iou, conf
            return f

        # the split stays on the card across sweeps; keyed by the host
        # array's identity, so a different split is never served stale
        img_entry = cache.get("__imgs__")
        if img_entry is None or img_entry[0] is not images:
            img_entry = cache["__imgs__"] = (
                images, torch.from_numpy(np.ascontiguousarray(images)).to(dev))
        img_dev = img_entry[1]
        jobs = []
        for (h0, w0), idxs in _groups(names, gt_sizes).items():
            gt_key = ("__gt__", h0, w0)
            if gt_key not in cache:     # uploaded once, reused by every sweep
                cache[gt_key] = _device_gt(gt_records, names, h0, w0, idxs,
                                           dev)
            gt_p, gt_a, row_of = cache[gt_key]
            gt_s = None
            if want_conf:
                sem_key = ("__gtsem__", h0, w0)
                if sem_key not in cache:
                    # rows in the cached GT's order (not this call's): both
                    # stacks are indexed with the same `rows`
                    stack = np.zeros((len(row_of), h0, w0), np.uint8)
                    for i in idxs:
                        stack[row_of[names[i]]] = gt_semantic[names[i]]
                    cache[sem_key] = torch.from_numpy(stack).to(dev)
                gt_s = cache[sem_key]
            run_s = cache.get(("score", h0, w0, want_conf))
            if run_s is None:
                run_s = cache[("score", h0, w0, want_conf)] = \
                    make_run_scored(h0, w0)
                warm = _pad_batch(b, images[idxs[:1]], windows[idxs[:1]])
                rows0 = torch.zeros((b,), dtype=torch.int64, device=dev)
                run_s(torch.from_numpy(warm[0]).to(dev),
                      torch.from_numpy(warm[1]).to(dev), gt_p, gt_a, rows0,
                      gt_s)[0].cpu()
            for v in range(0, len(idxs), b):
                sel = idxs[v:v + b]
                rows = [row_of[names[i]] for i in sel]
                rows += [rows[-1]] * (b - len(rows))       # pad rows too
                jobs.append((run_s, sel, gt_p, gt_a, rows, gt_s))

        def launch(job):
            run_s, sel, gt_p, gt_a, rows, gt_s = job
            # tail batches repeat the last index; `sel` bounds the fetch
            sel_pad = list(sel) + [sel[-1]] * (b - len(sel))
            imgs = img_dev[torch.tensor(sel_pad, device=dev)]
            wins = _pad_windows(b, windows[sel])
            return run_s(imgs, torch.from_numpy(wins).to(dev), gt_p, gt_a,
                         torch.tensor(rows, device=dev), gt_s)

        def collect(job, out):
            sel = job[1]
            for i, ix in enumerate(sel):
                entry = {"imname": names[ix], "boxes": out[0][i],
                         "valid": out[1][i], "iou": out[2][i]}
                if len(out) > 3:
                    entry["confusion"] = out[3][i]
                by_name[names[ix]] = entry

        t_pred = _pipelined(jobs, launch, collect, dev, timing)
        return [by_name[nm] for nm in names], t_pred

    if device_paste:
        assert gt_sizes is not None, "device_paste needs per-image sizes"

        def make_run_pasted(h0, w0):
            def f(imgs, wins):
                dets, masks = api.predict(model, imgs, wins, device=dev)
                full, valid = paste.paste_masks_single(masks, dets, h0, w0,
                                                       cfg.test_size)
                # packed before the fetch: 8 pixels per byte
                out = (dets, paste.pack_mask_bits(full), valid)
                if not want_semantic:
                    return out
                return out + (paste.merged_semantic_single(
                    full, dets[..., 4], valid),)
            return f

        jobs = []
        for (h0, w0), idxs in _groups(names, gt_sizes).items():
            run_p = cache.get((h0, w0, want_semantic))
            if run_p is None:
                run_p = cache[(h0, w0, want_semantic)] = make_run_pasted(h0,
                                                                         w0)
                warm = _pad_batch(b, images[idxs[:1]], windows[idxs[:1]])
                run_p(torch.from_numpy(warm[0]).to(dev),
                      torch.from_numpy(warm[1]).to(dev))[0].cpu()
            for v in range(0, len(idxs), b):
                jobs.append((run_p, idxs[v:v + b]))

        def launch(job):
            run_p, sel = job
            imgs, wins = _pad_batch(b, images[sel], windows[sel])
            return run_p(torch.from_numpy(imgs).to(dev),
                         torch.from_numpy(wins).to(dev))

        def collect(job, out):
            for i, ix in enumerate(job[1]):
                entry = {"imname": names[ix], "boxes": out[0][i],
                         "full_masks_packed": out[1][i], "valid": out[2][i]}
                if len(out) > 3:
                    entry["semantic"] = out[3][i]
                by_name[names[ix]] = entry

        t_pred = _pipelined(jobs, launch, collect, dev, timing)
        return [by_name[nm] for nm in names], t_pred

    run = predict_fn or (lambda imgs, wins: api.predict(model, imgs, wins,
                                                        device=dev))
    if not getattr(run, "_warmed", False):
        warm, wins = _pad_batch(b, images[:0], windows[:0])
        run(torch.from_numpy(warm).to(dev),
            torch.from_numpy(wins).to(dev))[0].cpu()
    n = len(names)
    detdata: List[Dict] = []

    def launch(v):
        imgs, wins = _pad_batch(b, images[v:v + b], windows[v:v + b])
        return run(torch.from_numpy(imgs).to(dev),
                   torch.from_numpy(wins).to(dev))

    def collect(v, out):
        for i in range(min(b, n - v)):
            detdata.append({"imname": names[v + i], "boxes": out[0][i],
                            "masks": out[1][i]})

    t_pred = _pipelined(range(0, n, b), launch, collect, dev, timing)
    return detdata, t_pred

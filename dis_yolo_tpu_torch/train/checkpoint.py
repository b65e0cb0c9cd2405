"""Checkpoints in torch format, and the TF1 and darknet weight bridges
(the counterpart of ``dis_yolo_tpu/train/checkpoint.py``).

Directory layout, as the JAX package's:

  <ckpt_dir>/config.txt                the run's config (the Solver)
  <ckpt_dir>/best.json                 {"step", "mAP"} of the best validation
  <ckpt_dir>/step_XXXXXXXX/state       ``torch.save`` of the whole train state:
                                       the model's state_dict (parameters, BN
                                       statistics), Adam's ``mu``/``nu`` and
                                       counters, the step
  <ckpt_dir>/step_XXXXXXXX/weights     the model's state_dict alone (the
                                       stage bridge: ``restore_weights``)

Every tensor is saved from the host (``.cpu()``), so a checkpoint loads
on any device.  A step's directory is written under a temporary name and
renamed when complete, so an interrupted save never looks like a
checkpoint.  Orbax checkpoints of the JAX package do not load here: the
weights cross over through ``models/weights.py``'s tree bridge.

Data parallelism (a process group of several ranks, the state
replicated): rank 0 (``is_primary``) alone writes, then every rank waits
at a barrier (``_sync``), so every rank can restore the step when the
save returns; the background saver falls back to that synchronous save,
as the JAX package's does on several processes.  Pruning and
``best.json`` are rank 0's too.

``save_checkpoint_background`` clones the state on the device (fast,
decoupled from the live tensors the next step updates in place), then
one worker thread copies the clone to the host on a side stream and
writes it.  At most one snapshot is queued: a save first waits for the
previous one.  A failed background save raises at the next save (and at
``check_background_saves``), not only at the end of the run; the steps
whose save is still in flight are listed by ``pending_steps`` so pruning
spares them.

Two restore modes mirror the reference: stage-1 selective (backbone and
detection-head conv_bn layers {1-52, 53-58, 60-66, 68-74} and the bias
convs {59, 67, 75} from a pretrained TF1 checkpoint, the mask subnet at
init) and stage-2 full.  ``tf1_name_map`` is the TF scope-name
correspondence (``yolo/convolutionalN/{weights,biases,BatchNorm/{beta,
gamma,moving_mean,moving_variance}}``); TF1 kernels are HWIO, the
state_dict's OIHW.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dis_yolo_tpu_torch.parallel.distributed import process_count

# Layers restored in stage 1 (the reference's train_yolo3_mask.py:77-103)
STAGE1_CONV_BN = tuple(range(1, 53)) + tuple(range(53, 59)) + \
    tuple(range(60, 67)) + tuple(range(68, 75))
STAGE1_CONV_BIAS = (59, 67, 75)


def is_primary() -> bool:
    """True on the process that owns host-side artifacts (logs, pruning,
    checkpoints): rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _sync(tag: str) -> None:
    """A barrier of every process (none with one process); ``tag`` names
    it in an error."""
    if process_count() > 1:
        try:
            dist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"checkpoint barrier {tag!r} failed") from e


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def _is_step_dir(name: str) -> bool:
    return (name.startswith("step_") and len(name) == 13
            and name[5:].isdigit())


def _host_state(state) -> Dict:
    """The train state as a dict of tensors on the host."""
    return {"model": OrderedDict((k, v.detach().cpu())
                                 for k, v in state.model.state_dict().items()),
            "mu": {k: v.detach().cpu() for k, v in state.opt.mu.items()},
            "nu": {k: v.detach().cpu() for k, v in state.opt.nu.items()},
            "count": int(state.opt.count),
            "notfinite_count": int(state.opt.notfinite_count),
            "total_notfinite": int(state.opt.total_notfinite),
            "step": int(state.step)}


def _write(ckpt_dir: str, step: int, host: Dict) -> str:
    path = _step_dir(ckpt_dir, step)
    tmp = path + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(host, os.path.join(tmp, "state"))
    torch.save(host["model"], os.path.join(tmp, "weights"))
    if os.path.isdir(path):             # a re-run over an older save
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir: str, state, step: int) -> str:
    """Save the whole train state and the weights alone, synchronously:
    rank 0 writes, and every rank returns once the step is on disk.
    Returns the step's directory."""
    wait_for_checkpoints()
    if is_primary():
        _write(ckpt_dir, step, _host_state(state))
    _sync(f"save step {step}")
    return _step_dir(ckpt_dir, step)


# ---------------------------------------------------------------- background

_SAVE_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_PENDING: List[Tuple[int, concurrent.futures.Future]] = []
_PENDING_LOCK = threading.Lock()


def _snapshot(state) -> Tuple[Dict, Optional[torch.cuda.Event]]:
    """The train state cloned where it lives (on the device: no host copy
    yet), and on CUDA the event that marks the clone done."""
    with torch.no_grad():
        snap = {"model": OrderedDict((k, v.detach().clone()) for k, v in
                                     state.model.state_dict().items()),
                "mu": {k: v.clone() for k, v in state.opt.mu.items()},
                "nu": {k: v.clone() for k, v in state.opt.nu.items()},
                "count": int(state.opt.count),
                "notfinite_count": int(state.opt.notfinite_count),
                "total_notfinite": int(state.opt.total_notfinite),
                "step": int(state.step)}
    done = None
    first = next(iter(snap["model"].values()))
    if first.is_cuda:
        done = torch.cuda.Event()
        done.record()
    return snap, done


def _to_host(snap: Dict, done) -> Dict:
    """Copy a snapshot to pinned host memory on a side stream (after the
    clone's event) and wait for it."""
    if done is None:
        return snap
    side = torch.cuda.Stream()
    side.wait_event(done)
    with torch.cuda.stream(side):
        host = {k: (OrderedDict((n, t.to("cpu", non_blocking=True))
                                for n, t in v.items())
                    if isinstance(v, dict) else v) for k, v in snap.items()}
    side.synchronize()
    return host


def _save_snapshot(ckpt_dir: str, step: int, snap: Dict, done) -> str:
    return _write(ckpt_dir, step, _to_host(snap, done))


def check_background_saves() -> None:
    """Raise the error of a finished background save that failed."""
    with _PENDING_LOCK:
        finished = [(s, f) for s, f in _PENDING if f.done()]
        for item in finished:
            _PENDING.remove(item)
    for step, fut in finished:
        err = fut.exception()
        if err is not None:
            raise RuntimeError(f"background checkpoint save of step {step} "
                               "failed") from err


def pending_steps() -> Tuple[int, ...]:
    """Steps whose background save has not finished."""
    with _PENDING_LOCK:
        return tuple(s for s, f in _PENDING if not f.done())


def wait_for_checkpoints() -> None:
    """Block until every background save has finished; raise the first
    failure."""
    with _PENDING_LOCK:
        futures = list(_PENDING)
    for _, fut in futures:
        concurrent.futures.wait([fut])
    check_background_saves()


def save_checkpoint_background(ckpt_dir: str, state, step: int) -> str:
    """Snapshot the state on the device and save it on a worker thread.

    Waits for the previous background save first (at most one snapshot
    queued; its failure raises here).  Returns the step's directory,
    which appears when the write is complete.  With several processes
    it is ``save_checkpoint``: the barrier after rank 0's write cannot
    run on a worker thread of every rank."""
    global _SAVE_POOL
    if process_count() > 1:
        return save_checkpoint(ckpt_dir, state, step)
    wait_for_checkpoints()
    if _SAVE_POOL is None:
        _SAVE_POOL = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt_save")
    snap, done = _snapshot(state)
    fut = _SAVE_POOL.submit(_save_snapshot, ckpt_dir, step, snap, done)
    with _PENDING_LOCK:
        _PENDING.append((step, fut))
    return _step_dir(ckpt_dir, step)


# ---------------------------------------------------------------- directory

def prune_checkpoints(ckpt_dir: str, keep: int,
                      protect: Iterable[int] = ()) -> None:
    """Delete all but the newest ``keep`` step directories; ``keep <= 0``
    keeps all (the reference keeps every checkpoint).  Steps in
    ``protect`` survive whatever their age (the Solver passes the step
    just saved, the best step and ``pending_steps()``)."""
    if keep <= 0 or not is_primary() or not os.path.isdir(ckpt_dir):
        return
    keep_names = {f"step_{s:08d}" for s in protect}
    steps = sorted(d for d in os.listdir(ckpt_dir) if _is_step_dir(d))
    for d in steps[:-keep]:
        if d not in keep_names:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def mark_best(ckpt_dir: str, step: int, map50: float) -> None:
    """Record the best-validation checkpoint in ``best.json``."""
    if not is_primary():
        return
    with open(os.path.join(ckpt_dir, "best.json"), "w") as f:
        json.dump({"step": int(step), "mAP": float(map50)}, f)


def read_best(ckpt_dir: str) -> Optional[dict]:
    """{'step', 'mAP'} of the tracked best-validation checkpoint, or None."""
    path = os.path.join(ckpt_dir, "best.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def best_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the best-validation checkpoint if it exists on disk."""
    best = read_best(ckpt_dir)
    if best is None:
        return None
    path = _step_dir(ckpt_dir, best["step"])
    return path if os.path.isdir(path) else None


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest complete step directory, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if _is_step_dir(d))
    return os.path.join(os.path.abspath(ckpt_dir), steps[-1]) if steps else None


# ---------------------------------------------------------------- restore

def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state):
    """Load a whole train state saved by ``save_checkpoint*`` into
    ``state`` (a ``train_step.TrainState``), in place, bit for bit:
    parameters, BN statistics, Adam's moments and counters, the step.
    Returns ``state``."""
    saved = _load(os.path.join(path, "state"))
    state.model.load_state_dict(saved["model"])
    opt = state.opt
    if set(saved["mu"]) != set(opt.mu):
        raise ValueError(f"{path}: the saved optimizer's trainable "
                         "parameters differ from this state's (another "
                         "stage?); use restore_weights for the stage bridge")
    with torch.no_grad():
        for name in opt.mu:
            opt.mu[name].copy_(saved["mu"][name])
            opt.nu[name].copy_(saved["nu"][name])
    opt.count = saved["count"]
    opt.notfinite_count = saved["notfinite_count"]
    opt.total_notfinite = saved["total_notfinite"]
    state.step = saved["step"]
    return state


def restore_weights(path: str, model) -> None:
    """Load only the weights (parameters and BN statistics) of a
    checkpoint into ``model``, in place: the stage-1 -> stage-2 bridge."""
    model.load_state_dict(_load(os.path.join(path, "weights")))


# ---------------------------------------------------------------- TF1 bridge

def tf1_name_map(layer_id: int, has_bn: bool) -> Dict[str, str]:
    """Flax param path suffix -> TF1 variable name for one conv layer."""
    scope = f"yolo/convolutional{layer_id}"
    if has_bn:
        return {
            "conv/kernel": f"{scope}/weights",
            "bn/scale": f"{scope}/BatchNorm/gamma",
            "bn/bias": f"{scope}/BatchNorm/beta",
            "bn/mean": f"{scope}/BatchNorm/moving_mean",
            "bn/var": f"{scope}/BatchNorm/moving_variance",
        }
    return {
        "conv/kernel": f"{scope}/weights",
        "conv/bias": f"{scope}/biases",
    }


# the state_dict entry of each tf1_name_map key
_SD_ENTRY = {"conv/kernel": "conv.weight", "conv/bias": "conv.bias",
             "bn/scale": "bn.weight", "bn/bias": "bn.bias",
             "bn/mean": "bn.running_mean", "bn/var": "bn.running_var"}


def _conv_layers(sd: Mapping[str, torch.Tensor]) -> List[Tuple[int, str, bool]]:
    """(id, name, has_bn) of every convolutionalN of a state_dict, by id."""
    names = {k.split(".", 1)[0] for k in sd if k.startswith("convolutional")}
    layers = [(int(n[len("convolutional"):]), n, f"{n}.bn.weight" in sd)
              for n in names]
    return sorted(layers)


def load_tf1_weights(sd: Mapping[str, torch.Tensor],
                     tf1_values: Mapping[str, np.ndarray],
                     layers: Optional[Iterable[int]] = None,
                     ignore_missing: bool = True
                     ) -> "OrderedDict[str, torch.Tensor]":
    """A copy of state_dict ``sd`` with the {tf1_name: ndarray} values
    merged in; ``layers=None`` takes every conv layer present (stage 2),
    ``STAGE1_CONV_BN + STAGE1_CONV_BIAS`` the stage-1 selection."""
    out = OrderedDict((k, v.clone()) for k, v in sd.items())
    wanted = set(layers) if layers is not None else None
    for lid, name, has_bn in _conv_layers(sd):
        if wanted is not None and lid not in wanted:
            continue
        for key, tf_name in tf1_name_map(lid, has_bn).items():
            if tf_name not in tf1_values:
                if ignore_missing:
                    continue
                raise KeyError(tf_name)
            val = np.asarray(tf1_values[tf_name])
            if key == "conv/kernel":                    # HWIO -> OIHW
                val = val.transpose(3, 2, 0, 1)
            entry = f"{name}.{_SD_ENTRY[key]}"
            ref = out[entry]
            assert tuple(ref.shape) == val.shape, (tf_name, tuple(ref.shape),
                                                   val.shape)
            out[entry] = torch.from_numpy(np.array(val, order="C")).to(
                dtype=ref.dtype, device=ref.device)
    return out


def export_tf1_weights(sd: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """state_dict -> {tf1_scope_name: ndarray} (HWIO kernels), the inverse
    of ``load_tf1_weights``."""
    out: Dict[str, np.ndarray] = {}
    for lid, name, has_bn in _conv_layers(sd):
        for key, tf_name in tf1_name_map(lid, has_bn).items():
            val = sd[f"{name}.{_SD_ENTRY[key]}"].detach().cpu().numpy()
            if key == "conv/kernel":
                val = val.transpose(2, 3, 1, 0)
            out[tf_name] = np.ascontiguousarray(val)
    return out


def convert_tf1_checkpoint(ckpt_path: str) -> Dict[str, np.ndarray]:
    """Read a TF1 V2 (TensorBundle) .ckpt into {name: ndarray} with the
    port's native reader (``train/tensorbundle.py``).  V1 single-file
    checkpoints need TensorFlow, which the port does not use."""
    from dis_yolo_tpu_torch.train.tensorbundle import read_tensor_bundle
    if os.path.isfile(ckpt_path + ".index"):
        return read_tensor_bundle(ckpt_path)
    raise FileNotFoundError(
        f"{ckpt_path}: no TensorBundle (V2) checkpoint ({ckpt_path}.index + "
        ".data-*); a V1 single-file checkpoint must be re-saved once with a "
        "TF1 V2 saver")


def stage1_restore(sd: Mapping[str, torch.Tensor],
                   tf1_values: Mapping[str, np.ndarray]
                   ) -> "OrderedDict[str, torch.Tensor]":
    """Selective stage-1 restore (the mask subnet stays at init)."""
    return load_tf1_weights(sd, tf1_values,
                            layers=set(STAGE1_CONV_BN) | set(STAGE1_CONV_BIAS),
                            ignore_missing=True)


# ---------------------------------------------------------------- darknet

def read_darknet_weights(path: str, sd: Mapping[str, torch.Tensor],
                         source_classes: Optional[int] = 80
                         ) -> Dict[str, np.ndarray]:
    """Parse a darknet ``yolov3.weights`` binary into {tf1_name: ndarray}.

    Layers conv1-75 are serialized in this model's conv order, each as
    [bn beta, gamma, moving_mean, moving_var | conv bias] then the OIHW
    kernel, after a 5-word header (4 int32 + an int64 image counter from
    format 0.2).  ``sd`` gives the shapes (a state_dict; a model on the
    ``meta`` device will do).  With ``source_classes`` different from
    this model's classes the three detection convs (59/67/75) are cropped
    per anchor to the first ``num_class`` class channels; None requires
    exact shapes.  The mask subnet (76+) has no darknet counterpart."""
    with open(path, "rb") as f:
        major, minor = np.fromfile(f, np.int32, 2)
        np.fromfile(f, np.int32, 1)                      # revision
        if int(major) * 10 + int(minor) >= 2:
            np.fromfile(f, np.int64, 1)
        else:
            np.fromfile(f, np.int32, 1)
        buf = np.fromfile(f, np.float32)

    pos = 0

    def take(n: int, what: str) -> np.ndarray:
        nonlocal pos
        if pos + n > buf.size:
            raise ValueError(
                f"darknet file truncated at {what}: need {n} floats, "
                f"{buf.size - pos} left — wrong architecture or classes?")
        out = buf[pos:pos + n]
        pos += n
        return out

    values: Dict[str, np.ndarray] = {}
    for lid in range(1, 76):
        name = f"convolutional{lid}"
        has_bn = f"{name}.bn.weight" in sd
        cout, cin, kh, kw = sd[f"{name}.conv.weight"].shape
        file_cout = cout
        crop = None
        if not has_bn and source_classes is not None:
            per_anchor = cout // 3
            num_class = per_anchor - 5
            if num_class != source_classes:
                if num_class > source_classes:
                    raise ValueError(
                        f"model has {num_class} classes but the .weights "
                        f"file only {source_classes}; cropping cannot "
                        "invent channels — restore the backbone only")
                file_cout = 3 * (5 + source_classes)
                crop = (per_anchor, 5 + source_classes)
        names = tf1_name_map(lid, has_bn)
        if has_bn:
            values[names["bn/bias"]] = take(cout, f"conv{lid} bn beta").copy()
            values[names["bn/scale"]] = take(cout, f"conv{lid} bn gamma").copy()
            values[names["bn/mean"]] = take(cout, f"conv{lid} bn mean").copy()
            values[names["bn/var"]] = take(cout, f"conv{lid} bn var").copy()
        else:
            bias = take(file_cout, f"conv{lid} bias")
            if crop:
                bias = bias.reshape(3, crop[1])[:, :crop[0]].reshape(-1)
            values[names["conv/bias"]] = bias.copy()
        kernel = take(file_cout * cin * kh * kw, f"conv{lid} kernel")
        kernel = kernel.reshape(file_cout, cin, kh, kw)      # darknet OIHW
        if crop:
            kernel = (kernel.reshape(3, crop[1], cin, kh, kw)[:, :crop[0]]
                      .reshape(3 * crop[0], cin, kh, kw))
        values[names["conv/kernel"]] = kernel.transpose(2, 3, 1, 0).copy()
    if pos != buf.size:
        raise ValueError(
            f"darknet file has {buf.size - pos} unread floats after "
            f"conv75 — source_classes={source_classes} wrong, or not a "
            "YOLOv3 .weights file")
    return values

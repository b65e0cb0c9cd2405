"""The port's spans and counters, and its profiler window (the counterpart
of ``dis_yolo_tpu/utils/profiling.py``).

  * ``span(name)``: a ``torch.profiler.record_function`` range named
    ``dis_yolo.<name>`` around one layer of the program, so that a
    profiler trace holds the program's layers beside the card's kernels,
    copies and memsets, on one clock.  Spans are off unless turned on
    (``tracing()``, ``trace(logdir)``); off, a span is one global read and
    a shared no-op context.  Under ``torch.compile`` or ``torch.export``
    tracing a span is always the no-op, so no graph holds a profiler
    node.
  * ``count(name, n)``: an always-on counter in a module-level registry
    (``counters()``, ``reset_counters()``); nothing counts while
    ``torch.compile`` or ``torch.export`` traces.
  * ``trace(logdir)``: a ``torch.profiler`` window with spans on (CPU,
    and the card's kernels where there is one), written to
    ``logdir/trace.json`` for Perfetto or ``chrome://tracing``.

Spans of the serving path (each ``dis_yolo.``-prefixed):

  backbone          ``DISYolo.forward``: the input cast and permute,
                    conv1-52
  heads             conv53-75 and the three raw head outputs
  mask_decoder      conv76-85, the score maps' permute and cast, the
                    outputs' copies (and the height-shard gather)
  decode            ``api.predict_from_outputs``: ``decode_all``
  nms               ``nms.filter_detections``: scores, shortlist, NMS
                    engine, the fallback
  nms.full_pass     the fallback's full pass, when it runs (in ``nms``)
  box_drop          the degenerate-box drop
  assemble          K1 (or the gather route)
  paste.taps        ``paste.paste_masks_batch``: boxes to original
                    pixels, validity, the tap tables of both axes (and
                    on CUDA the clamped class ids)
  paste.k5          on CUDA: K5, the masks, ``> 0.5``, the validity mask
                    and the semantic map in one launch
  paste.gemm        on the CPU: the two interpolation matrices, the two
                    products, ``> 0.5`` and the validity mask
  paste.semantic    on the CPU: the per-class semantic map
  quant.quantize    in each int8 ``QuantConv`` (``models/quant.py``): its
                    input to NHWC int8
  quant.im2col      the int8 padding and the unfold into the im2col
                    matrix (a 1x1 stride-1 layer's input is its matrix)
  quant.int_mm      ``torch._int_mm``, the s8 x s8 -> s32 GEMM
  quant.dequant     the float32 dequantization, the bias, the cast to the
                    compute dtype and the leaky ReLU

The three forward spans tile ``DISYolo.forward``; ``decode``, ``nms``,
``box_drop`` and ``assemble`` tile ``predict_from_outputs``; the paste
spans tile ``paste_masks_batch``: ``paste.taps`` and ``paste.k5`` on
CUDA, ``paste.taps``, ``paste.gemm`` and ``paste.semantic`` on the CPU.
The four ``quant.*`` spans tile an int8 layer's forward, inside the
forward's spans.

Counters:

  nms.sweeps          fixpoint NMS sweeps run
  nms.full_passes     fallback full passes run
  sync.nms_loop       the fixpoint loop's predicate reads on the host
  sync.nms_fallback   the fallback predicate's read on the host
  sync.decode         host values copied to the card in ``decode``, each
                      with a stream sync (on CUDA)
  sync.paste          list indices copied to the card in
                      ``paste.correct_boxes_device`` (on CUDA)
  kernel.k1 .. k5     launches of K1 (assembly), K2 (NMS), K3 (assembly
                      backward), K4 (channel extraction), K5 (paste)
  quant.layers        int8 ``QuantConv`` forwards
  quant.im2col_bytes  bytes of the im2col matrices they build
  quant.int_mm_ops    their GEMMs' operations, 2 M N K each (the shapes
                      before ``_int_mm``'s zero padding)

The ``quant.*`` counters count only while spans are on (``on()``): off,
an int8 layer pays one global read for them.

Each ``sync.*`` count is one wait of the host for the card's stream:
with the driver's fetch of the results they are every host sync of a
serving batch.  On the CPU NMS's reads are counted too.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch

_ON = False
_NOOP = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}


def _traced() -> bool:
    """True while ``torch.compile`` or ``torch.export`` traces."""
    return torch.compiler.is_compiling()


def span(name: str):
    """A context manager: ``record_function("dis_yolo." + name)`` while
    spans are on, else the shared no-op."""
    if not _ON or _traced():
        return _NOOP
    return torch.profiler.record_function("dis_yolo." + name)


def on() -> bool:
    """True while spans are on and no compiler traces."""
    return _ON and not _traced()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _traced():
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


@contextlib.contextmanager
def tracing(on: bool = True):
    """Turn spans on (or off) for the block."""
    global _ON
    before, _ON = _ON, on
    try:
        yield
    finally:
        _ON = before


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with spans on; yields the
    ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing(), profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

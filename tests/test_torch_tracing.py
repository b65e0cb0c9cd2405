"""The port's spans and counters (``dis_yolo_tpu_torch/utils/profiling.py``)
on the CPU, at 64 px:

  * spans off enter no ``record_function``; spans on emit each span of
    the serving path once per call, nested as the module says;
  * the three forward spans tile ``DISYolo.forward``, the four
    post-forward spans ``predict_from_outputs`` and the three paste spans
    ``paste_masks_batch``: every operation lies under exactly one, at
    mask stride 2 and 1;
  * ``nms.sweeps`` counts the fixpoint sweeps of a suppression chain of
    known depth, ``sync.nms_loop`` and ``sync.nms_fallback`` the host
    reads of NMS's predicates; ``nms.full_passes`` and the span
    ``dis_yolo.nms.full_pass`` count the fallback only when the
    shortlist underfills;
  * the ``kernel.k*`` counters stay still on CPU tensors;
  * ``torch.export`` with spans on records no profiler node and counts
    nothing;
  * ``trace(logdir)`` writes a trace that holds the spans.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from dis_yolo_tpu_torch import export as exp
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.ops import cuda_assembly, custom_ops, nms, paste
from dis_yolo_tpu_torch.utils import profiling

FORWARD = ("dis_yolo.backbone", "dis_yolo.heads", "dis_yolo.mask_decoder")
POST = ("dis_yolo.decode", "dis_yolo.nms", "dis_yolo.box_drop",
        "dis_yolo.assemble")
PASTE = ("dis_yolo.paste.taps", "dis_yolo.paste.gemm",
         "dis_yolo.paste.semantic")


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _model(mask_stride=2, **kw):
    cfg = DISYoloConfig(image_size=64, test_size=64, mask_stride=mask_stride,
                        **kw)
    return api.init_model(cfg, 0, device="cpu")


def _inputs(b=2):
    x = torch.rand(b, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    return x, torch.tensor([[0.0, 0.0, 1.0, 1.0]] * b)


def _serve(model, x, w):
    dets, masks = api.predict(model, x, w, 0.0, device="cpu")
    return paste.paste_masks_batch(masks, dets, 48, 64, 64)


def _profiled(fn):
    """FunctionEvents of ``fn()`` under the profiler with spans on, and
    the ``outer`` range around it."""
    with profiling.tracing(), profile(activities=[ProfilerActivity.CPU]) \
            as prof:
        with record_function("outer"):
            fn()
    events = prof.events()
    return events, next(e for e in events if e.name == "outer")


def test_spans_off_enter_no_record_function(monkeypatch):
    model = _model()
    x, w = _inputs()
    entered = []
    real = torch.profiler.record_function

    def spy(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    _serve(model, x, w)
    assert entered == []
    assert profiling.span("backbone") is profiling.span("nms")
    with profiling.tracing():
        _serve(model, x, w)
    assert set(FORWARD + POST + PASTE) <= set(entered)


def test_spans_on_emit_each_span_once_per_call_and_nest():
    model = _model()
    x, w = _inputs()
    events, _ = _profiled(lambda: [_serve(model, x, w) for _ in range(2)])
    spans = [e for e in events if e.name.startswith("dis_yolo.")]
    names = [e.name for e in spans]
    for name in FORWARD + POST + PASTE:
        assert names.count(name) == 2, name
    assert "dis_yolo.nms.full_pass" not in names
    for e in spans:
        # every span of the path sits directly in the caller's range
        assert e.cpu_parent is not None and e.cpu_parent.name == "outer"


@pytest.mark.parametrize("mask_stride", [2, 1])
def test_spans_tile_forward_post_and_paste(mask_stride):
    model = _model(mask_stride)
    x, w = _inputs()
    cfg = model.cfg
    raws = api.forward(model, x, "cpu")
    dets, masks = api.predict_from_outputs(cfg, raws, w, 0.0, "cpu")
    calls = (
        (lambda: model(x), FORWARD),
        (lambda: api.predict_from_outputs(cfg, raws, w, 0.0, "cpu"), POST),
        (lambda: paste.paste_masks_batch(masks, dets, 48, 64, 64), PASTE))
    for fn, tiles in calls:
        with torch.no_grad():
            _, outer = _profiled(fn)
        # every operation of the call is inside one of its spans, and the
        # spans are siblings, so none is inside two
        assert [c.name for c in outer.cpu_children] == list(tiles)
        assert all(c.cpu_children for c in outer.cpu_children)


@pytest.mark.parametrize("depth", [0, 1, 4, 7])
def test_nms_counts_the_sweeps_of_a_suppression_chain(depth, monkeypatch):
    """Boxes 0.4 apart on one row, one class, falling scores: each
    suppresses the next (IoU 0.43 > 0.3) and not the one after (0.11), so
    the fixpoint settles after ``depth`` sweeps and keeps every second
    box.  ``sync.nms_loop`` equals the predicate reads the loop makes on
    the host (each ``Tensor.__bool__``): one after every sweep, and
    before the first one or, when it loops, two."""
    n = depth + 1
    boxes = torch.tensor([[0.0, 0.4 * i, 1.0, 0.4 * i + 1.0]
                          for i in range(n)])[None]
    scores = torch.linspace(0.9, 0.5, n)[None]
    classes = torch.zeros((1, n), dtype=torch.int32)
    valid = torch.ones((1, n), dtype=torch.bool)
    reads = []
    real = torch.Tensor.__bool__

    def read(t):
        reads.append(t)
        return real(t)

    monkeypatch.setattr(torch.Tensor, "__bool__", read)
    profiling.reset_counters()
    picked = nms._fixpoint_nms(boxes, scores, classes, valid, 0.3, 30)
    monkeypatch.undo()
    got = profiling.counters()
    assert got.get("nms.sweeps", 0) == depth
    assert got["sync.nms_loop"] == len(reads) == depth + 1 + (depth > 0)
    assert picked[0, :(n + 1) // 2].tolist() == list(range(0, n, 2))
    assert (picked[0, (n + 1) // 2:] == -1).all()


def test_nms_full_pass_only_when_the_shortlist_underfills(monkeypatch):
    """All-zero head outputs give every anchor the same score over the
    threshold and heavily overlapping boxes: a shortlist of 8 keeps fewer
    than 30 and leaves candidates out, so the fallback runs; a shortlist
    of every candidate does not fall short.  Either way the ``sync.*``
    counters hold every host read of a tensor's truth value."""
    x, w = _inputs(1)
    model = _model()
    raws = [torch.zeros_like(r) for r in api.forward(model, x, "cpu")]
    reads = []
    real = torch.Tensor.__bool__

    def read(t):
        reads.append(t)
        return real(t)

    for top_k, want in ((512, 0), (8, 1)):
        cfg = model.cfg.replace(pre_nms_top_k=top_k)
        profiling.reset_counters()
        reads.clear()
        monkeypatch.setattr(torch.Tensor, "__bool__", read)
        events, _ = _profiled(
            lambda: api.predict_from_outputs(cfg, raws, w, 0.1, "cpu"))
        monkeypatch.undo()
        got = profiling.counters()
        assert got.get("nms.full_passes", 0) == want
        assert got["sync.nms_fallback"] == 1
        assert got["sync.nms_loop"] + 1 == len(reads)
        full = [e for e in events if e.name == "dis_yolo.nms.full_pass"]
        assert len(full) == want
        for e in full:
            assert e.cpu_parent.name == "dis_yolo.nms"


def test_kernel_counters_stay_still_on_cpu_tensors():
    before = {k: v for k, v in profiling.counters().items()
              if k.startswith("kernel.")}
    sm = torch.rand(1, 8, 8, 9)
    bx = torch.tensor([[[0.1, 0.1, 0.6, 0.7]] * 3])
    custom_ops.assemble_masks_batch_cuda(sm, bx, 3)
    cuda_assembly.assemble_bwd_cuda(torch.zeros((1, 3, 4)),
                                    torch.rand(1, 3, 8, 8), 3)
    cuda_assembly.extract_planes_cuda(torch.rand(1, 8, 72), 3)
    custom_ops.nms_cuda(torch.rand(1, 16, 4), torch.rand(1, 16),
                        torch.zeros((1, 16), dtype=torch.int32),
                        torch.ones((1, 16), dtype=torch.bool), 5, 0.3)
    _serve(_model(), *_inputs(1))
    assert {k: v for k, v in profiling.counters().items()
            if k.startswith("kernel.")} == before


def test_export_with_spans_on_records_no_profiler_node_and_counts_nothing():
    model = _model(pre_nms_top_k=64)
    profiling.reset_counters()
    with profiling.tracing():
        ep = exp.export_predict(model.cfg, model, batch_size=2,
                                obj_thresh=0.5, device="cpu")
    assert profiling.counters() == {}
    targets = [str(n.target) for gm in ep.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule)
               for n in gm.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t
                            or "record_function" in t]
    # the graph's loop and fallback are graph operators: they run
    # without the eager code that counts (K1's launches still count on
    # CUDA, in its operator)
    with profiling.tracing():
        ep.module()(*_inputs())
    assert profiling.counters() == {}


def test_counters_round_trip():
    profiling.reset_counters()
    profiling.count("a")
    profiling.count("a", 2)
    profiling.count("b", 0)
    got = profiling.counters()
    assert got == {"a": 3, "b": 0}
    got["a"] = 10
    assert profiling.counters()["a"] == 3
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_trace_writes_the_spans(tmp_path):
    model = _model()
    x, w = _inputs(1)
    with profiling.trace(str(tmp_path)):
        _serve(model, x, w)
    with open(tmp_path / "trace.json") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    names = {e.get("name") for e in events}
    assert set(FORWARD + POST + PASTE) <= names
    assert not profiling._ON

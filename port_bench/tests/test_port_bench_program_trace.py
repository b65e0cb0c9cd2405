"""The reduction of the program's spans (``port_bench/program_trace.py``):
a hand-built event list, the nine readers on a hand-built ``Outcome``,
and the driver's program block on the tiny cell on the CPU."""

import pytest
import torch

from port_bench import harness, program_trace, trace
from port_bench.weights import make_weights
from port_bench.tests.tiny import tiny_context


def _ann(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": 1}


def _op(cat, name, ts, dur, corr):
    return [{"cat": "cuda_runtime", "name": "launch", "ts": ts - 5,
             "args": {"correlation": corr}},
            {"cat": cat, "name": name, "ts": ts, "dur": dur,
             "args": {"correlation": corr}}]


def _events():
    """One batch: the driver's ``forward`` [0, 50] holds
    ``dis_yolo.backbone`` [1, 30], which holds ``dis_yolo.nms`` [10, 20]
    (nested here only to test nesting); ``paste`` [60, 90] holds
    ``dis_yolo.paste.gemm`` [62, 80].  The card: a [10, 20] and b [18, 25]
    launched at 5 and 13 (under backbone, then nms), c [40, 45] launched
    at 35 (under forward alone), d [70, 75] launched at 65 (under
    paste.gemm), e [92, 95] launched at 87 (under paste alone), f
    [96, 98] launched outside every span."""
    return ([_ann(trace.WINDOW_SPAN, 0, 100), _ann("forward", 0, 50),
             _ann("dis_yolo.backbone", 1, 29), _ann("dis_yolo.nms", 10, 10),
             _ann("paste", 60, 30), _ann("dis_yolo.paste.gemm", 62, 18)]
            + _op("kernel", "a", 10, 10, 1) + _op("kernel", "b", 18, 7, 2)
            + _op("gpu_memcpy", "c", 40, 5, 3) + _op("kernel", "d", 70, 5, 4)
            + [{"cat": "cuda_runtime", "name": "launch", "ts": 87,
                "args": {"correlation": 5}},
               {"cat": "kernel", "name": "e", "ts": 92, "dur": 3,
                "args": {"correlation": 5}}]
            + [{"cat": "cuda_runtime", "name": "launch", "ts": 55,
                "args": {"correlation": 6}},
               {"cat": "kernel", "name": "f", "ts": 96, "dur": 2,
                "args": {"correlation": 6}}])


def test_reduce_program_books_device_and_idle_time_to_the_innermost_span():
    got = program_trace.reduce_program(_events(), calls=2)
    sp = got["spans"]
    # device: a under backbone only, b under nms and backbone
    assert sp["dis_yolo.nms"]["device_ms"] == pytest.approx(7e-3 / 2)
    assert sp["dis_yolo.backbone"]["device_ms"] == pytest.approx(17e-3 / 2)
    assert sp["dis_yolo.paste.gemm"]["device_ms"] == pytest.approx(5e-3 / 2)
    # idle gaps by where they start: [0, 10] and [45, 70] in forward
    # under no program span, [25, 40] in backbone (nms closed at 20),
    # [75, 92] in paste.gemm, [95, 96] and [98, 100] outside every span
    assert sp["dis_yolo.backbone"]["idle_ms"] == pytest.approx(15e-3 / 2)
    assert sp["dis_yolo.nms"]["idle_ms"] == 0.0
    assert sp["dis_yolo.paste.gemm"]["idle_ms"] == pytest.approx(17e-3 / 2)
    un = got["unspanned"]
    assert un["forward"]["device_ms"] == pytest.approx(5e-3 / 2)
    assert un["forward"]["idle_ms"] == pytest.approx(35e-3 / 2)
    assert un["paste"]["device_ms"] == pytest.approx(3e-3 / 2)
    assert un["outside"]["device_ms"] == pytest.approx(2e-3 / 2)
    assert un["outside"]["idle_ms"] == pytest.approx(3e-3 / 2)
    assert got["driver_device_ms"] == pytest.approx(
        {"forward": 22e-3 / 2, "paste": 8e-3 / 2})
    # host self: backbone 29 less nms 10; calls per batch
    assert sp["dis_yolo.backbone"]["host_self_ms"] == pytest.approx(19e-3 / 2)
    assert sp["dis_yolo.nms"]["host_self_ms"] == pytest.approx(10e-3 / 2)
    assert sp["dis_yolo.backbone"]["calls"] == 0.5
    # busy [10, 25] [40, 45] [70, 75] [92, 95] [96, 98]: 30 us of 100
    assert got["busy_ms"] == pytest.approx(30e-3 / 2)
    assert got["window_ms"] == pytest.approx(100e-3 / 2)
    # every device and idle microsecond is booked once at the top level
    top = (sp["dis_yolo.backbone"], sp["dis_yolo.paste.gemm"],
           *un.values())
    assert sum(r["device_ms"] for r in top) == pytest.approx(32e-3 / 2)
    assert sum(r["idle_ms"] for r in top) == pytest.approx(70e-3 / 2)


def test_reduce_program_needs_one_window():
    with pytest.raises(RuntimeError, match="profiled_window"):
        program_trace.reduce_program(_events()[1:], calls=1)


def _program():
    spans = {n: {"device_ms": d, "idle_ms": i, "host_self_ms": 1.0,
                 "calls": 1.0}
             for n, d, i in (("dis_yolo.backbone", 10.0, 4.0),
                             ("dis_yolo.heads", 2.0, 1.0),
                             ("dis_yolo.mask_decoder", 1.5, 0.5),
                             ("dis_yolo.nms", 0.4, 2.5),
                             ("dis_yolo.paste.taps", 3.0, 0.0),
                             ("dis_yolo.paste.gemm", 4.0, 0.2))}
    return {"batches": 20, "spans": spans, "unspanned": {},
            "driver_device_ms": {}, "counters_per_batch": {"nms.sweeps": 14.5},
            "syncs_debug_per_batch": 20.0, "syncs_program_per_batch": 18.0}


def test_the_nine_readers():
    out = harness.Outcome(e2e={}, attempted=1, failed=0,
                          memory_peak_bytes=0, checks=[],
                          counters={"program": _program()})
    got = program_trace.metrics(out.counters["program"])
    assert got == {"backbone_ms.serve": 10.0, "heads_ms.serve": 2.0,
                   "mask_decoder_ms.serve": 1.5,
                   "forward_idle_ms.serve": 5.5, "nms_ms.serve": 0.4,
                   "nms_idle_ms.serve": 2.5,
                   "nms_sweeps_per_batch.serve": 14.5,
                   "paste_taps_ms.serve": 3.0, "paste_gemm_ms.serve": 4.0}
    # a program without spans or counters (an older one): nothing to read
    assert set(program_trace.metrics(None).values()) == {None}
    bare = dict(_program(), spans={}, counters_per_batch={})
    assert set(program_trace.metrics(bare).values()) == {None}


def test_the_program_block_on_the_tiny_cell():
    """The driver's block on a CPU server: every span of the path once a
    batch, the counters per batch, and the sync count handed back."""
    from port_bench.drivers import serve
    ctx = tiny_context()
    cfg = serve._cfg(ctx.config)
    pool = serve.Pool(ctx.traffic, cfg.image_size, ctx.seed, "cpu")
    weights = make_weights(serve._specs(cfg), ctx.seed, "cpu",
                           pool.images[pool.order[0]])
    server = serve.Server(cfg, serve.build_model(cfg, weights, "default",
                                                 pool, "cpu"),
                          pool, 0.5, "cpu")
    seen = []

    def count_syncs(server, positions):
        for p in positions:
            server.batch(server.pool.at(p))
        seen.append(list(positions))
        return 4.0

    with torch.no_grad():
        got = program_trace.program_window(server, 3, 2, 1, count_syncs)
    assert seen == [[5]]
    names = {"dis_yolo." + n for n in (
        "backbone", "heads", "mask_decoder", "decode", "nms", "box_drop",
        "assemble", "paste.taps", "paste.gemm", "paste.semantic")}
    assert names <= set(got["spans"])
    assert all(got["spans"][n]["calls"] == 1.0 for n in names)
    assert got["counters_per_batch"]["sync.nms_fallback"] == 1.0
    assert got["counters_per_batch"]["sync.nms_loop"] >= 1.0
    assert got["syncs_debug_per_batch"] == 4.0
    # the fallback's read and at least one read of the loop
    assert got["syncs_program_per_batch"] >= 2.0

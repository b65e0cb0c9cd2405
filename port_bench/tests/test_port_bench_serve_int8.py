"""The int8 serving cell: its driver at 64 px on the CPU, the control and
the faults that set its limits, ``work_int8``'s operation count, the new
metric readers, and on the card the control and faults at the cell's own
size.

    python -m pytest port_bench/tests/test_port_bench_serve_int8.py -q

The card case skips where there is no CUDA card."""

import pytest

from port_bench import control, manifest, work_int8
from port_bench.reference.net import layer_specs
from port_bench.tests.tiny import tiny_context, tiny_run
from port_bench.trace import Trace

CELL = "s2-int8-serve-b8-dense"
SEEDS = [2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203]
FAULTS = ["scales_x2", "fault_scale", "fault_bias"]


def _checks(out):
    return {name: (value, limit) for name, value, limit in out.checks}


def test_the_int8_cell_runs_and_is_correct():
    out = tiny_run(CELL)
    assert out.attempted > 0 and out.failed == 0
    assert out.correct, out.checks
    assert set(_checks(out)) == set(manifest.limits(CELL))
    assert set(out.e2e) == {"serve_img_per_s", "serve_batch_p95_ms",
                            "peak_mem_gib", "setup_s"}
    assert out.counters["judged"]["rerun_diff"] == 0
    assert out.counters["int8_ops_per_image"] > 0
    assert 0 < out.counters["ideal_s_per_image"]


@pytest.mark.parametrize("graph,caught_by", [
    ("scales_x2", "raw_err"), ("fault_scale", "scale_err"),
    ("fault_bias", "raw_err")])
def test_the_control_and_the_faults_are_not_correct(graph, caught_by):
    out = manifest.driver("serve_int8").run(tiny_context(CELL), graph=graph)
    assert out.attempted > 0 and not out.correct
    value, limit = _checks(out)[caught_by]
    assert value > limit, out.checks


def test_a_broken_stem_fails_stem_err(monkeypatch):
    from dis_yolo_tpu_torch.models import layers
    forward = layers.DeployConv.forward

    def scaled(self, x):
        return forward(self, x) * 1.5

    monkeypatch.setattr(layers.DeployConv, "forward", scaled)
    out = tiny_run(CELL)
    assert not out.correct
    value, limit = _checks(out)["stem_err"]
    assert value > limit


def test_work_int8_counts_one_3x3_and_one_1x1_layer_by_hand():
    specs = layer_specs(576, 2, 3, 3)
    # layer 5: 3x3, 64 -> 128, stride 2, out 144 x 144
    assert work_int8.forward_ops(specs, 576, 2, (5,))[0] == \
        2 * 144 * 144 * 128 * 64 * 9 == 3_057_647_616
    # layer 6: 1x1, 128 -> 64, at 144 x 144
    assert work_int8.forward_ops(specs, 576, 2, (6,))[0] == \
        2 * 144 * 144 * 64 * 128 == 339_738_624
    int8, other = work_int8.forward_ops(specs, 576, 2, range(5, 86))
    assert int8 + other == 132_683_857_920


class _Out:
    def __init__(self, trace=None, counters=None):
        self.trace, self.counters = trace, counters or {}


def _trace(calls=2):
    ops = [(0.0, 0.002, "void cutlass::Kernel2<cutlass_80_tensorop_"
            "i16832gemm_s8_128x64_128x3_tn_align16>", "forward", "kernel"),
           (0.01, 0.001, "cutlass_80_tensorop_i16832gemm_s8_64x64", "forward",
            "kernel"),
           (0.02, 0.004, "void at::native::elementwise_kernel", "forward",
            "kernel"),
           (0.03, 0.001, "Memcpy HtoD", "h2d", "gpu_memcpy")]
    return Trace(window_s=0.1, busy_s=0.008, calls=calls, ops=ops)


def _reader(name):
    return manifest.metric_reader(name)


def test_the_new_readers_on_a_synthetic_trace():
    t = _trace()
    # 3 ms of int8 GEMMs over 2 batches
    assert _reader("int8_gemm_ms.serve").read(_Out(t)) == pytest.approx(1.5)
    c = {"int8_ops_per_image": 1e9, "images_per_batch": 8.0,
         "rate_img_per_s": 200.0, "ideal_s_per_image": 5e-5}
    share = 2 * 8 * 1e9 / work_int8.INT8_OPS / 0.003 * 100
    assert _reader("int8_gemm_roofline.serve").read(_Out(t, c)) == \
        pytest.approx(share)
    assert _reader("mfu_int8.serve").read(_Out(t, c)) == pytest.approx(1.0)
    program = {"spans": {
        "dis_yolo.quant.quantize": {"device_ms": 1.0},
        "dis_yolo.quant.im2col": {"device_ms": 2.0},
        "dis_yolo.quant.int_mm": {"device_ms": 4.0},
        "dis_yolo.quant.dequant": {"device_ms": 0.5},
        "dis_yolo.backbone": {"device_ms": 9.0}}}
    assert _reader("int8_glue_ms.serve").read(
        _Out(t, {"program": program})) == pytest.approx(3.5)


@pytest.mark.parametrize("name", ["int8_gemm_ms.serve", "int8_glue_ms.serve",
                                  "int8_gemm_roofline.serve",
                                  "mfu_int8.serve"])
def test_a_reader_with_nothing_to_read_gives_none(name):
    r = _reader(name)
    assert r.read(_Out()) is None
    no_gemm = Trace(window_s=0.1, busy_s=0.0, calls=2, ops=[
        (0.0, 0.001, "void at::native::elementwise_kernel", "forward",
         "kernel")])
    # a program without the quant spans (the parent's) opens none
    no_spans = {"program": {"spans": {"dis_yolo.backbone":
                                      {"device_ms": 9.0}}},
                "int8_ops_per_image": 1e9, "images_per_batch": 8.0}
    assert r.read(_Out(no_gemm, no_spans)) is None


@pytest.mark.card
def test_on_the_card_the_control_and_faults_fail_and_the_port_passes(card):
    rows = control.readings(CELL, SEEDS, ["default"] + FAULTS, 2.0,
                            device=str(card))
    assert all(r["correct"] for r in rows if r["graph"] == "default"), rows
    assert not any(r["correct"] for r in rows if r["graph"] != "default"), \
        rows

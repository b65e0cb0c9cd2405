"""The port's int8 serving graph (``quant``) against the benchmark's plain
int8 reference (``port_bench/reference/quant.py``) on the CPU at 64 px,
with the benchmark's seeded random weights, and the spans and counters of
the quantized conv (``models/quant.py``, ``utils/profiling.py``).

  * the whole graph, the reference given the program's stem outputs
    (layers 1-4) and the program's calibration, within the cell
    ``s2-int8-serve-b8-dense``'s ``raw_err`` limit; the control, every
    activation scale doubled (inputs at 7 bits), outside it;
  * one layer's int8 input and int32 accumulators against the
    reference's float64 sums on the same input, exactly;
  * the reference's calibration against ``quant.calibrate_deploy``'s:
    the same rule (a float32 graph agrees to float32 rounding) and, in
    bfloat16, within the cell's ``scale_err`` limit;
  * spans and counters: none with spans off, and with them on one
    forward counts every int8 layer and ``work_int8``'s operations.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api, fold, quant
from dis_yolo_tpu_torch.utils import profiling
from port_bench import work_int8
from port_bench.reference import net as ref_net
from port_bench.reference import quant as ref_quant
from port_bench.weights import make_weights, program_state_dict

SIZE = 64
LIMITS = json.loads((Path(__file__).resolve().parents[1] / "port_bench"
                     / "limits" / "s2-int8-serve-b8-dense.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(mask_stride=2, dtype="bfloat16"):
    cfg = DISYoloConfig()
    return cfg.replace(image_size=SIZE, test_size=SIZE, quant=True,
                       mask_stride=mask_stride, compute_dtype=dtype,
                       anchors=tuple((a * SIZE / 576, b * SIZE / 576)
                                     for a, b in cfg.anchors))


def _images(seed, n=2):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, SIZE, SIZE, 3), generator=g)


class _Graph:
    """Weights, the program's calibration and int8 model, and the
    reference's pieces, for one configuration."""

    def __init__(self, cfg, seed=11):
        self.cfg = cfg
        self.specs = ref_net.layer_specs(SIZE, cfg.mask_stride, cfg.num_class,
                                         cfg.k_map, cfg.anchors_per_scale)
        self.images = _images(seed)
        self.weights = make_weights(self.specs, seed, "cpu", self.images)
        self.dsd = fold.deploy_variables(program_state_dict(self.weights))
        self.absmax = quant.calibrate_deploy(
            api.create_model(cfg.replace(quant_calibrate=True), "cpu"),
            self.dsd, self.images)
        self.model = self.int8_model(self.absmax)

    def int8_model(self, absmax):
        model = api.create_model(self.cfg, "cpu")
        model.load_state_dict(quant.quantize_deploy(self.dsd, absmax))
        return model

    def forward_with_stem(self, model):
        """The program's raw outputs and its outputs of the stem."""
        stem = ref_quant.stem_layers(self.specs, self.cfg.quant_layers)
        got = {}
        hooks = [getattr(model, f"convolutional{i}").register_forward_hook(
            lambda mod, inp, out, i=i: got.__setitem__(i, out.detach()))
            for i in stem]
        try:
            raws = api.forward(model, self.images, "cpu")
        finally:
            for h in hooks:
                h.remove()
        return raws, got

    def reference(self, absmax):
        return ref_quant.Int8Net(self.specs, self.weights, absmax,
                                 self.cfg.quant_layers)


def _raw_err(raws, ref_raws):
    errs = [float((p.double() - r.double()).norm() / r.double().norm())
            for p, r in zip(raws, ref_raws)]
    return math.sqrt(sum(e * e for e in errs) / len(errs))


@pytest.fixture(scope="module")
def s2():
    return _Graph(_cfg())


@pytest.mark.parametrize("mask_stride", [2, 1])
def test_the_int8_graph_matches_the_reference_from_its_stem(mask_stride, s2):
    g = s2 if mask_stride == 2 else _Graph(_cfg(mask_stride))
    raws, stem = g.forward_with_stem(g.model)
    ref = g.reference(g.absmax)
    ref_raws = ref(g.images, stem)
    assert sorted(ref.forced_err) == [1, 2, 3, 4]
    assert max(ref.forced_err.values()) <= LIMITS["stem_err"]
    assert _raw_err(raws, ref_raws) <= LIMITS["raw_err"]


def test_the_7bit_control_fails_raw_err(s2):
    control = s2.int8_model({k: 2.0 * v for k, v in s2.absmax.items()})
    raws, stem = s2.forward_with_stem(control)
    ref_raws = s2.reference(s2.absmax)(s2.images, stem)
    assert _raw_err(raws, ref_raws) > LIMITS["raw_err"]


@pytest.mark.parametrize("layer", [5, 6, 27, 81])
def test_one_layers_accumulators_equal_the_float64_sums(layer, s2):
    """Layer ``layer`` on the input the program gave it: the int8 values
    and the int32 accumulators equal the reference's quantization and
    float64 sums, computed from the same folded weights and scale."""
    mod = getattr(s2.model, f"convolutional{layer}")
    seen = {}

    def keep_input(m, inp, out):
        seen["x"] = inp[0].detach()

    hook = mod.register_forward_hook(keep_input)
    try:
        api.forward(s2.model, s2.images, "cpu")
    finally:
        hook.remove()
    x = seen["x"]
    ref = s2.reference(s2.absmax)
    _, w_int, inv_s_x, _, _ = ref.layers[layer]
    x_int = ref_quant.quantize_input(x, inv_s_x)
    x_q = quant.quantize_input(x, mod.inv_sx)
    assert torch.equal(x_q.permute(0, 3, 1, 2).double(), x_int)
    assert torch.equal(mod.w_q.double(), w_int)
    acc = mod.accumulate(x).permute(0, 3, 1, 2)
    want = ref_quant.accumulate(x_int, w_int, ref.specs[layer][5])
    assert acc.dtype == torch.int32
    assert torch.equal(acc.double(), want)


@pytest.mark.parametrize("dtype,limit", [("float32", 1e-5),
                                         ("bfloat16", LIMITS["scale_err"])])
def test_the_references_calibration_agrees(dtype, limit, s2):
    g = s2 if dtype == "bfloat16" else _Graph(_cfg(dtype=dtype))
    mine = ref_quant.calibrate(g.specs, g.weights, g.images,
                               g.cfg.quant_layers)
    assert sorted(mine) == sorted(g.absmax)
    assert ref_quant.scale_gap(g.absmax, mine) <= limit


def _int8_layers(model):
    return sum(isinstance(m, quant.QuantConv) for m in model.children())


def _quant_counters():
    return {k: v for k, v in profiling.counters().items()
            if k.startswith("quant.")}


def test_with_spans_off_a_forward_opens_no_span_and_counts_nothing(
        s2, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    before = _quant_counters()
    api.forward(s2.model, s2.images, "cpu")
    assert opened == []
    assert _quant_counters() == before


def test_with_spans_on_a_forward_counts_each_int8_layer_and_its_ops(s2):
    from torch.profiler import ProfilerActivity, profile
    profiling.reset_counters()
    with profiling.tracing(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        api.forward(s2.model, s2.images, "cpu")
    c = profiling.counters()
    n = _int8_layers(s2.model)
    assert n == 74
    assert c["quant.layers"] == n
    int8_ops, _ = work_int8.forward_ops(s2.specs, SIZE, 2,
                                        s2.cfg.quant_layers)
    assert c["quant.int_mm_ops"] == int8_ops * s2.images.shape[0]
    assert c["quant.im2col_bytes"] > 0
    names = [e.name for e in prof.events()]
    for span in ("quantize", "im2col", "int_mm", "dequant"):
        assert names.count(f"dis_yolo.quant.{span}") == n

"""The work counts against counts made by hand."""

import pytest
import torch
import torch.nn.functional as F

from port_bench import work
from port_bench.reference import net as ref_net


def _specs(stride, size=576):
    return ref_net.layer_specs(size, stride, 3, 3)


@pytest.mark.parametrize("stride,gflop", [(2, 132_683_857_920),
                                          (1, 136_516_534_272)])
def test_forward_flops_at_576(stride, gflop):
    assert work.forward_flops(_specs(stride), 576, stride) == gflop


@pytest.mark.parametrize("stride,bucket", [(2, 126.57), (1, 130.40)])
def test_bucket_flops_missed_one_3x3_conv_in_two_towers(stride, bucket):
    # forward_budget.bucket_flops counts two 3x3 convs in the stride-16
    # and stride-8 towers, which have three (layers 62/64/66, 70/72/74)
    missing = (2 * 256 * 512 * 9 * 36 * 36) + (2 * 128 * 256 * 9 * 72 * 72)
    got = work.forward_flops(_specs(stride), 576, stride) - missing
    assert got / 1e9 == pytest.approx(bucket, abs=0.005)


@pytest.mark.parametrize("stride", [1, 2])
def test_forward_flops_count_every_conv_the_reference_runs(stride,
                                                           monkeypatch):
    """At 64 px, count each conv's multiply-adds as the reference calls
    F.conv2d: output elements x input channels x kernel area."""
    specs = ref_net.layer_specs(64, stride, 3, 3)
    weights = {k: torch.zeros(s) for k, s in ref_net.param_shapes(specs).items()}
    for k in weights:
        if k.endswith("running_var"):
            weights[k] += 1.0
    counted = []
    conv2d = F.conv2d

    def counting(x, w, b=None, stride=1, *a, **kw):
        y = conv2d(x, w, b, stride, *a, **kw)
        counted.append(2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return y

    monkeypatch.setattr(ref_net.F, "conv2d", counting)
    ref_net.Net(specs, weights)(torch.zeros(1, 64, 64, 3))
    assert len(counted) == len(specs)
    assert work.forward_flops(specs, 64, stride) == sum(counted)


def test_k1_counts_by_hand():
    # B=1, S=4, k=3, D=3: a 2x2 box at the corner, a 2x3 box over its
    # lower row (4 more pixels covered), a padding row; masks 3*4*4
    # floats written, 8 map pixels read, boxes 3*4 floats; 10 pixels
    # inside their boxes
    boxes = [[[0.0, 0.0, 0.5, 0.5], [0.25, 0.0, 0.75, 0.75],
              [0.0, 0.0, 0.0, 0.0]]]
    assert work.k1_work(boxes, 4, 3) == (192 + 32 + 48, 10 * (6 + 2 * 2))


def test_k3_counts_by_hand():
    # 10 gradient pixels inside the ROIs, 2 boxes, a 4x4x9 dense output
    assert work.k3_bytes(10, 2, 1, 4, 3) == 40 + 32 + 576


def test_paste_counts_by_hand():
    # one valid 2x3 box on a 4x5 photo, 4x4 masks: the mask read (64 B),
    # its 4x5 boolean mask and the 4x5 semantic map written, 6 pixels
    # with 4 taps (8 operations) each
    assert work.paste_work([(0, 0, 2, 3)], 1, 4, 5, 4) == (104.0, 48.0)
    assert work.paste_work([], 2, 4, 5, 4) == (40.0, 0.0)


def test_roofline_takes_the_larger_bound():
    t, by = work.roofline_s(3.35e12, 1.0)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = work.roofline_s(1.0, 67e12)
    assert (t, by) == (pytest.approx(1.0), "operations")

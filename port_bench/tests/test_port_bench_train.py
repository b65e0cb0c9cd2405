"""The training driver's whole run at 64 px on the CPU, sound and with
the timed path broken underneath: each fault must turn ``correct``
false, through the check named beside it.  The sound run is the port's
step at ``compute_dtype="float32"`` (``tiny_train``), so it also holds
the reference's float32 step to the port's."""

import pytest

from port_bench import manifest
from port_bench.tests.tiny_train import CELL, tiny_train_run


def test_the_training_run_is_correct():
    out = tiny_train_run()
    assert out.attempted > 0 and out.failed == 0
    assert out.correct, out.checks
    assert {name for name, _, _ in out.checks} == set(manifest.limits(CELL))
    assert set(out.e2e) == {"train_img_per_s", "peak_mem_gib", "setup_s"}
    assert out.e2e["train_img_per_s"] > 0
    assert out.counters["flops_per_image"] > 0
    got = {name: value for name, value, _ in out.checks}
    judged = out.counters["judged"]
    assert judged["leaves_left_out"] == 0
    assert got["data_diff"] == 0
    # the first step starts both sides from the same weights and images
    # and runs the same float32 operations; only the convolutions'
    # padding (the port pads inside the convolution where it can) and
    # the order of some sums may differ
    assert got["raw_err"] <= 1e-6
    assert judged["loss_err_by_step"][0] <= 1e-6
    assert got["stats_err"] <= 1e-5
    # the loss terms of the port's own raw outputs: float32 on both
    # sides, the sums over the grid in another order at later steps
    assert got["raw_loss_err"] <= 1e-4
    # the backward's operations differ in order (K3's plain scatter
    # against autograd's, the convolutions' gradients), and at 64 px
    # train-mode BatchNorm over 8 values a channel at stride 32 amplifies
    # float32 rounding there: 4.9e-4 read on the worst leaf
    assert got["grad_err"] <= 1e-4
    assert judged["grad_worst"] <= 5e-3
    # Adam's first updates are nearly the sign of each gradient element,
    # so the gradients' rounding moves the change of a few small leaves:
    # 0.0087 read on the worst leaf
    assert got["update_err"] <= 0.05


@pytest.mark.parametrize("fault,caught_by", [
    ("frozen", "update_err"),       # Adam skipped: parameters unchanged
    ("half", "data_diff"),          # half the batch, the mean over the rest
    ("noaug", "data_diff"),         # flips and photometric skipped
    ("nomask", "raw_loss_err"),     # the mask loss dropped from the total
    ("bneval", "raw_err"),          # BatchNorm in eval mode in the step
    ("fp8", "raw_err")])            # the control: convolutions' inputs in fp8
def test_a_broken_training_step_is_not_correct(fault, caught_by):
    out = tiny_train_run(graph=fault)
    assert out.attempted > 0
    assert not out.correct
    checks = {name: (value, limit) for name, value, limit in out.checks}
    assert checks[caught_by][0] > checks[caught_by][1], checks

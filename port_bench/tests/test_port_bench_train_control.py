"""The training cell's control and faults, on the card at the cell's own
size: the float8 control (every convolution's input rounded to e4m3),
half of the batch left out, and the mask loss dropped from the total
must each come out not correct, and the port as configured correct, on
three seeds (the driver's judged block, a short window).

    python -m pytest port_bench/tests/test_port_bench_train_control.py -q

Skips where there is no CUDA card."""

import pytest

from port_bench import control

CELL = "s2-train-stage2-b16"
SEEDS = [2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303]


@pytest.mark.card
def test_the_fp8_control_and_the_faults_fail_and_the_port_passes(card):
    rows = control.readings(CELL, SEEDS, ["default", "fp8", "half", "nomask"],
                            1.0, device=str(card))
    assert all(r["correct"] for r in rows if r["graph"] == "default"), rows
    assert not any(r["correct"] for r in rows if r["graph"] != "default"), \
        rows

"""The control of the correctness check, on the card: the port's own
int8 serving graph, the nearest precision below the configuration's
bfloat16, must come out not correct in every serving cell, and the port
as configured correct, on three seeds at the cell's own size and load
(short windows).

    python -m pytest port_bench/tests/test_port_bench_control.py -q

Skips where there is no CUDA card."""

import pytest

from port_bench import control, manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]
         if manifest.traffic(w["traffic"])["driver"] == "serve"]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_int8_control_fails_and_the_port_passes(workload, card):
    rows = control.readings(workload, SEEDS, ["default", "int8"], 2.0,
                            device=str(card))
    assert all(r["correct"] for r in rows if r["graph"] == "default"), rows
    assert not any(r["correct"] for r in rows if r["graph"] == "int8"), rows

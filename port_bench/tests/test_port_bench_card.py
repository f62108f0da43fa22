"""On the card, at each cell's own size: the program comes out correct and
its control (the reference at fp8 in the program's place) does not, on
three seeds; nor does the program with a bias and a LayerNorm shift left
out of the weights it loads, which the CPU's tiny label cell cannot show
(its logits spread too little for the full size's limit). Skips without a
card; run with ``python3 -m pytest port_bench/tests -m card``."""

import io
import json
import os

import pytest

from port_bench import harness, readings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", _cells())
def test_the_control_fails_where_the_program_passes(card, cell):
    limits = harness.plan(ROOT, cell).traffic["limits"]
    rows = readings.readings(cell, [7001, 7002, 7003], 10.0, True, device=card,
                             out=io.StringIO())
    for row in rows:
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row


@pytest.mark.card
@pytest.mark.parametrize("cell", _cells())
def test_a_dropped_bias_fails_at_the_cells_size(card, cell):
    limits = harness.plan(ROOT, cell).traffic["limits"]
    rows = readings.readings(cell, [7011, 7012, 7013], 3.0, False, device=card,
                             out=io.StringIO(), fault="bias_dropped", batches=1)
    for row in rows:
        assert any(v > limits[k] for k, v in row["program"].items()), row

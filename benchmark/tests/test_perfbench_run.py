"""Whole runs of every cell at a CPU size: the harness's path from the
seed to the result line, with the card's look skipped."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark.harness.runner import run_cell

CPU = torch.device("cpu")
CELLS = ["chr1-pair.job", "chr1-pair.query", "salmonella10.job"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(tiny_cell, workload, traced):
    cell = tiny_cell(workload)
    result, numbers = run_cell(cell, 2**31 + 77, 0.3, traced, CPU,
                               time.perf_counter())
    assert result["correct"] is True
    assert numbers == {"missing": 0, "extra": 0, "misplaced": 0,
                       "bad_size": 0}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert result["checks"]["missing"] == {"value": 0, "limit": 0}
    want = cell.per_layer if traced else cell.end_to_end
    names = {m["name"] for m in want}
    # on the CPU the device readers find nothing to read
    expect = {n for n in names if not n.startswith("device_idle_pct")
              and not n.endswith("_roofline")}
    assert set(result["metrics"]) == expect
    for m in want:
        if m["name"] in result["metrics"]:
            v = result["metrics"][m["name"]]
            assert v["unit"] == m["unit"] and v["value"] >= 0
    assert ("breakdown" in result) == traced
    json.dumps(result)


def test_same_seed_same_listing(tiny_cell):
    from benchmark.inputs.build import make_inputs

    cell = tiny_cell("salmonella10.job")
    a = make_inputs(cell.config, 12345, CPU)
    b = make_inputs(cell.config, 12345, CPU)
    c = make_inputs(cell.config, 12346, CPU)
    assert all(np.array_equal(x, y) for x, y in zip(a.queries, b.queries))
    assert not any(np.array_equal(x, y)
                   for x, y in zip(a.queries, c.queries))

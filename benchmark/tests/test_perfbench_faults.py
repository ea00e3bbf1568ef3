"""The check catches a broken timed path: a whole CPU run with a fault
planted underneath comes out not correct, and so does the control (the
reference at one more than its stride) in the program's place."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness.runner import run_cell
from slamem_tpu_torch.engine import run as engine
from slamem_tpu_torch.engine import seed_mode

CPU = torch.device("cpu")
CELLS = ["chr1-pair.job", "chr1-pair.query", "salmonella10.job"]


def _run(cell, **kw):
    return run_cell(cell, 4242, 0.3, False, CPU, time.perf_counter(), **kw)


def _alter_answer(monkeypatch):
    """One match's length changed where the engine produces it."""
    real = seed_mode.find_seed_matches

    def broken(*a, **kw):
        m = real(*a, **kw)
        m.length = m.length.copy()
        m.length[len(m.length) // 2] += 1
        return m

    monkeypatch.setattr(seed_mode, "find_seed_matches", broken)


def _half_left_out(monkeypatch):
    """Half of the request's entries (or of a single entry's matches)
    left out of the answer."""
    real = engine.run_engine

    def broken(*a, **kw):
        out = real(*a, **kw)
        if len(out.per_query) > 1:
            out.per_query = out.per_query[::2]
        else:
            qm = out.per_query[0]
            for f in ("ref_seq", "ref_pos", "q_pos", "length"):
                setattr(qm, f, getattr(qm, f)[::2])
        return out

    monkeypatch.setattr(engine, "run_engine", broken)


def _state_unchanged(monkeypatch):
    """The engine's step returns what it was given: no matches."""
    def broken(index, q, cfg, mesh=None):
        empty = np.zeros(0, np.int64)
        m = seed_mode.SeedMatches(empty, empty, empty)
        m.stats = {"pairs": 0, "k": 0, "stride": 1, "rounds": 0,
                   "stage_s": {}}
        return m

    monkeypatch.setattr(seed_mode, "find_seed_matches", broken)


@pytest.mark.parametrize("fault", [_alter_answer, _half_left_out,
                                   _state_unchanged])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(tiny_cell, monkeypatch, workload, fault):
    fault(monkeypatch)
    result, numbers = _run(tiny_cell(workload))
    assert result["correct"] is False
    assert numbers["missing"] > 0 or numbers["extra"] > 0
    assert result["failed"] >= 1


@pytest.mark.parametrize("config", ["chr1-pair", "salmonella10"])
def test_control_is_not_correct(tiny_cell, config):
    """benchmark/control.py at a CPU size: the control's listing, judged
    as an answer, misses MEMs on every seed."""
    import importlib.util

    from benchmark.harness.manifest import ROOT

    spec = importlib.util.spec_from_file_location(
        "benchmark_control", ROOT / "benchmark" / "control.py")
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    cell = tiny_cell(f"{config}.job", reference_length=1_000_000,
                     query_length=200_000)
    for seed in (1, 2, 3):
        r = control.control_readings(cell.config, seed, CPU)
        assert r["control_correct"] is False
        assert r["numbers"]["missing"] > 0 and r["numbers"]["extra"] == 0
        assert r["control_mems"] < r["mems"]


def test_sound_run_is_correct(tiny_cell):
    result, _ = _run(tiny_cell("salmonella10.job"))
    assert result["correct"] is True

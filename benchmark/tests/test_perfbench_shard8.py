"""The sharded-index cell ``chr1-pair.shard8-job`` through the whole
harness at the CPU size of ``test_perfbench_run.py``, traced and untraced,
and the readers of the slab program's spans on synthetic jobs."""

import time
import types

import pytest
import torch

from benchmark.harness.manifest import load_cell, load_metric
from benchmark.harness.runner import run_cell
from benchmark.harness.traffic import Answer

CPU = torch.device("cpu")
CELL = "chr1-pair.shard8-job"
SLAB_SPANS = {"job.slab_tables_s": "slab_tables",
              "job.slab_frontend_s": "slab_frontend",
              "job.slab_expand_s": "slab_expand",
              "job.slab_merge_s": "slab_merge"}


def _tiny_shard8(tiny_cell):
    """The new cell at the CPU size of the chr1 pair: its configuration
    holds the pair's inputs, so it takes the pair's cut."""
    pair = tiny_cell("chr1-pair.job").config
    cell = load_cell(CELL)
    cell.config.update({k: pair[k]
                        for k in ("reference_length", "query_length")})
    return cell


@pytest.mark.parametrize("traced", [False, True])
def test_shard8_cell_runs_correct(tiny_cell, traced):
    cell = _tiny_shard8(tiny_cell)
    assert cell.traffic["cli_args"] == ["-shard", "-slabs", "8"]
    result, numbers = run_cell(cell, 2**31 + 77, 0.3, traced, CPU,
                               time.perf_counter())
    assert result["correct"] is True
    assert numbers == {"missing": 0, "extra": 0, "misplaced": 0,
                       "bad_size": 0}
    assert result["attempted"] >= 1 and result["failed"] == 0
    want = cell.per_layer if traced else cell.end_to_end
    # on the CPU the device readers find nothing to read
    expect = {m["name"] for m in want
              if not m["name"].startswith("device_idle_pct")
              and not m["name"].endswith("_roofline")}
    assert set(result["metrics"]) == expect
    if not traced:
        assert expect == {"job_s", "setup_s"}
        return
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(SLAB_SPANS) | {"job.slab_pair_skew"} <= set(got)
    assert sum(got[m] for m in SLAB_SPANS) <= got["job.query_s"]
    assert got["job.slab_pair_skew"] >= 1.0
    assert result["metrics"]["job.slab_pair_skew"]["unit"] == "x"


def _rec(phase, seconds=0.0, **fields):
    return {"phase": phase, "seconds": seconds, "t0_ns": 0,
            "t1_ns": int(seconds * 1e9), **fields}


def _run(*jobs):
    return types.SimpleNamespace(answers=[
        Answer(wall_s=1.0, size=10, bases=100, phases=list(p))
        for p in jobs])


def _job(expand_s, merge_s, worst, pairs, rounds=2):
    out = [_rec("index_build", 0.5),
           _rec("slab_tables", 0.25, slabs=8, rows=16, R=4, shift=0,
                probes=0),
           _rec("slab_frontend", 0.125, windows=4, slab_pairs=[])]
    for r in range(rounds):
        out += [_rec("slab_expand", expand_s, round=r, rounds=rounds,
                     busy_slabs=8, pairs=pairs, worst_slab_pairs=worst),
                _rec("slab_merge", merge_s, round=r, runs=3)]
    return out + [_rec("query", 1.0)]


@pytest.mark.parametrize("metric", sorted(SLAB_SPANS))
def test_slab_span_reader(metric):
    """Each span's records of a job summed over its rounds, mean per job;
    nothing read from a program without the spans."""
    jobs = _run(_job(0.0625, 0.03125, 10, 80), _job(0.125, 0.0625, 10, 80))
    want = {"job.slab_tables_s": 0.25, "job.slab_frontend_s": 0.125,
            "job.slab_expand_s": (0.125 + 0.25) / 2,
            "job.slab_merge_s": (0.0625 + 0.125) / 2}[metric]
    read = load_metric(metric)
    assert read(jobs) == pytest.approx(want)
    assert read(_run([_rec("index_build", 0.5), _rec("query", 0.1)])) is None
    assert read(_run([], [])) is None


def test_slab_pair_skew_reader():
    """The worst slab over the slabs' mean, mean per job; a job with no
    pairs, no expansion or no spans reads nothing."""
    read = load_metric("job.slab_pair_skew")
    assert read(_run(_job(0.1, 0.1, 10, 80), _job(0.1, 0.1, 30, 80))) \
        == pytest.approx((1.0 + 3.0) / 2)
    assert read(_run(_job(0.1, 0.1, 10, 80), _job(0.1, 0.1, 0, 0))) \
        == pytest.approx(1.0)
    assert read(_run(_job(0.1, 0.1, 0, 0, rounds=0))) is None
    assert read(_run([_rec("query", 0.1)])) is None


def test_shard8_cell_reports_what_the_manifest_says():
    cell = load_cell(CELL)
    assert (cell.config_name, cell.traffic_name, cell.chips) == (
        "chr1-pair-shard8", "shard8-job", 1)
    # the chr1 pair's inputs, with the index in 8 slabs
    pair = load_cell("chr1-pair.job").config
    for key in ("reference_name", "reference_length", "query_entries",
                "query_length", "min_length"):
        assert cell.config[key] == pair[key]
    assert cell.config["index"]["slabs"] == 8
    assert cell.traffic["cli_args"][-1] == str(cell.config["index"]["slabs"])
    assert [m["name"] for m in cell.end_to_end] == ["job_s", "setup_s"]
    job = {m["name"] for m in load_cell("chr1-pair.job").per_layer}
    names = {m["name"] for m in cell.per_layer}
    assert names == (job | set(SLAB_SPANS) | {"job.slab_pair_skew"})
    for m in cell.per_layer:
        if m["name"] in SLAB_SPANS or m["name"] == "job.slab_pair_skew":
            assert m["layer"] == "slab program" and m["moves"] == "job_s"
            assert m["workloads"] == [CELL]
    new = set(SLAB_SPANS) | {"job.slab_pair_skew"}
    for other in ("chr1-pair.job", "salmonella10.job", "chr1-pair.query"):
        assert not new & {m["name"] for m in load_cell(other).per_layer}

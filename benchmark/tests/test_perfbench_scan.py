"""The scan-engine cell ``chr1-pair.scan-job`` through the whole harness
at the CPU size of ``test_perfbench_run.py``, traced and untraced, the
readers of the scan engine's spans on synthetic jobs, and the plain
reference of its mechanism (``reference/lcp.py``) on a tiny text."""

import time
import types

import pytest
import torch

from benchmark.harness.manifest import load_cell, load_metric
from benchmark.harness.runner import run_cell
from benchmark.harness.traffic import Answer
from benchmark.inputs.build import make_inputs
from benchmark.reference.lcp import intervals_plain, lcp_plain
from slamem_tpu_torch.index.build import build_index

CPU = torch.device("cpu")
CELL = "chr1-pair.scan-job"
SCAN_SPANS = {"job.scan_lcp_s": "scan_lcp", "job.scan_rows_s": "scan_rows",
              "job.scan_frontend_s": "frontend"}
PAIR_KEYS = ("reference_name", "reference_length", "query_entries",
             "query_length", "min_length")


def _tiny_scan(tiny_cell):
    """The new cell at the CPU size of the chr1 pair: its configuration
    holds the pair's inputs, so it takes the pair's cut."""
    pair = tiny_cell("chr1-pair.job").config
    cell = load_cell(CELL)
    cell.config.update({k: pair[k]
                        for k in ("reference_length", "query_length")})
    return cell


@pytest.mark.parametrize("traced", [False, True])
def test_scan_cell_runs_correct(tiny_cell, traced):
    cell = _tiny_scan(tiny_cell)
    assert cell.traffic["cli_args"] == ["-engine", "scan"]
    result, numbers = run_cell(cell, 2**31 + 91, 0.3, traced, CPU,
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
    assert set(SCAN_SPANS) <= set(got)
    assert all(got[m] > 0 for m in SCAN_SPANS)
    assert sum(got[m] for m in SCAN_SPANS) <= got["job.query_s"]


def _rec(phase, seconds=0.0, **fields):
    return {"phase": phase, "seconds": seconds, "t0_ns": 0,
            "t1_ns": int(seconds * 1e9), **fields}


def _run(*jobs):
    return types.SimpleNamespace(answers=[
        Answer(wall_s=1.0, size=10, bases=100, phases=list(p))
        for p in jobs])


def _job(lcp_s, rows_s, front_s):
    return [_rec("index_build", 0.5), _rec("upload", 0.01),
            _rec("scan_lcp", lcp_s, n=1001, rounds=5, bytes=20020),
            _rec("scan_rows", rows_s, rows=2, bytes=1024),
            _rec("frontend", front_s, chunks=1, launches=0),
            _rec("expand", 0.02), _rec("merge", 0.01), _rec("query", 1.0)]


@pytest.mark.parametrize("metric", sorted(SCAN_SPANS))
def test_scan_span_reader(metric):
    """Each span's records of a job, mean per job; nothing read from a
    program without the span (a parent whose scan builds its tables
    inside ``frontend`` reads that span alone)."""
    jobs = _run(_job(0.5, 0.125, 0.25), _job(0.25, 0.0625, 0.125))
    want = {"job.scan_lcp_s": 0.375, "job.scan_rows_s": 0.09375,
            "job.scan_frontend_s": 0.1875}[metric]
    read = load_metric(metric)
    assert read(jobs) == pytest.approx(want)
    before = _run([_rec("index_build", 0.5), _rec("upload", 0.01),
                   _rec("frontend", 0.8), _rec("query", 1.0)])
    assert (read(before) is None) == (metric != "job.scan_frontend_s")
    assert read(_run([_rec("index_build", 0.5), _rec("query", 0.1)])) \
        is None
    assert read(_run([], [])) is None


def test_scan_cell_reports_what_the_manifest_says():
    cell = load_cell(CELL)
    assert (cell.config_name, cell.traffic_name, cell.chips) == (
        "chr1-pair-scan", "scan-job", 1)
    # the chr1 pair's inputs, searched by the scan engine
    pair = load_cell("chr1-pair.job").config
    for key in PAIR_KEYS:
        assert cell.config[key] == pair[key]
    assert cell.config["reduced"] == pair["reduced"]
    assert cell.config["engine"]["search"] == "scan"
    assert [m["name"] for m in cell.end_to_end] == ["job_s", "setup_s"]
    job = {m["name"] for m in load_cell("chr1-pair.job").per_layer}
    names = {m["name"] for m in cell.per_layer}
    assert names == job | set(SCAN_SPANS)
    for m in cell.per_layer:
        if m["name"] in SCAN_SPANS:
            assert m["layer"] == "scan engine" and m["moves"] == "job_s"
            assert m["source"] == "program_span"
            assert m["workloads"] == [CELL]
    for other in ("chr1-pair.job", "salmonella10.job", "chr1-pair.query",
                  "chr1-pair.shard8-job"):
        assert not set(SCAN_SPANS) & {m["name"]
                                      for m in load_cell(other).per_layer}


@pytest.mark.parametrize("seed", [5, 2**31 + 13])
def test_scan_cell_inputs_are_the_chr1_pairs(tiny_cell, seed):
    """The same seed gives the same sequences as ``chr1-pair``, so the
    same files and the same listing."""
    pair = tiny_cell("chr1-pair.job").config
    scan = _tiny_scan(tiny_cell).config
    a, b = make_inputs(pair, seed, CPU), make_inputs(scan, seed, CPU)
    assert a.ref_names == b.ref_names and a.query_names == b.query_names
    assert all((x == y).all() for x, y in zip(a.refs + a.queries,
                                               b.refs + b.queries))


def test_plain_lcp_and_intervals_by_hand():
    """``lcp_plain`` and ``intervals_plain`` on a text small enough to
    check by eye: ACAC N ACA, then the terminator."""
    text = torch.tensor([0, 1, 0, 1, 4, 0, 1, 0, 5], dtype=torch.uint8)
    # suffixes in the contract's order: specials by position, then
    # A < C < G < T, a prefix before its extensions
    sa = torch.tensor([4, 8, 7, 2, 5, 0, 3, 6, 1], dtype=torch.int32)
    index = build_index(text[:-1].numpy(), device="cpu")
    assert torch.equal(index.text, text) and torch.equal(index.sa, sa)
    assert lcp_plain(text, sa).tolist() == [0, 0, 0, 1, 2, 3, 0, 1, 2]
    assert lcp_plain(text, sa, block=2).tolist() == \
        lcp_plain(text, sa).tolist()
    q = torch.tensor([0, 1, 0, 4, 1, 0], dtype=torch.uint8)
    lo, w = intervals_plain(text, sa, q, 2)
    # AC in rows 3..5, CA in 7..8, A N and N C hold a special, CA again,
    # and the last position runs past the end
    assert w.tolist() == [3, 2, 0, 0, 2, 0]
    assert lo.tolist() == [3, 7, 0, 0, 7, 0]

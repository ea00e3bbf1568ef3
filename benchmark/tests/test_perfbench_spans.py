"""The readers of the program's spans: each reads its span from synthetic
answers, and reads nothing from a program that does not log it."""

import types

import pytest

from benchmark.harness.manifest import load_cell, load_metric
from benchmark.harness.traffic import Answer

JOB_SPANS = {"job.fasta_read_s": "fasta_read",
             "job.fasta_parse_s": "fasta_parse", "job.render_s": "render",
             "job.write_s": "write", "job.join_s": "join",
             "job.emit_s": "emit"}


def _rec(phase, seconds):
    return {"phase": phase, "seconds": seconds, "t0_ns": 0,
            "t1_ns": int(seconds * 1e9)}


def _run(answers):
    return types.SimpleNamespace(answers=answers)


def _job(phases):
    return Answer(wall_s=1.0, size=10, bases=100, phases=phases)


@pytest.mark.parametrize("metric", sorted(JOB_SPANS))
def test_job_span_reader(metric):
    """Records of a job summed (two input files each), mean per job."""
    span = JOB_SPANS[metric]
    engine = [_rec("index_build", 0.5), _rec("query", 0.25)]
    jobs = [_job([_rec(span, 0.125), *engine, _rec(span, 0.25)]),
            _job([*engine, _rec(span, 0.5), _rec(span, 0.125)])]
    read = load_metric(metric)
    assert read(_run(jobs)) == pytest.approx((0.375 + 0.625) / 2)
    # a program without the span, an untraced run: nothing to read
    assert read(_run([_job(engine), _job(engine)])) is None
    assert read(_run([_job([]), _job([])])) is None


def _request(phases):
    return Answer(wall_s=0.2, size=10, bases=100,
                  stats={"query_s": 0.1, "searches": [], "phases": phases})


def test_query_emit_reader():
    read = load_metric("query.emit_ms")
    reqs = [_request([_rec("index_build", 0.0), _rec("query", 0.05),
                      _rec("emit", 0.004)]),
            _request([_rec("query", 0.05), _rec("emit", 0.006)])]
    assert read(_run(reqs)) == pytest.approx(5.0)
    assert read(_run([_request([_rec("query", 0.05)])])) is None
    assert read(_run([_job([_rec("emit", 0.1)])])) is None


def test_span_metrics_are_in_their_cells():
    for cell, names in (
            ("chr1-pair.job", set(JOB_SPANS) - {"job.join_s"}),
            ("salmonella10.job", set(JOB_SPANS)),
            ("chr1-pair.query", {"query.emit_ms"})):
        got = {m["name"] for m in load_cell(cell).per_layer}
        assert names <= got, cell
        assert not ({*JOB_SPANS, "query.emit_ms"} - names) & got, cell

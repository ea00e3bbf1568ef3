"""The harness finds configurations, mixes and metrics by the names in
BENCHMARK.json: a new one is new files and entries, with no edit."""

import json
import shutil

import pytest

from benchmark.harness.manifest import ROOT, load_cell, load_kind, \
    load_manifest, load_metric
from benchmark.harness.traffic import Mix


def test_every_manifest_name_has_its_file():
    m = load_manifest()
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    for w in m["workloads"]:
        cell = load_cell(w["name"], m)
        assert issubclass(load_kind(cell.traffic["kind"]), Mix)
        for metric in cell.end_to_end + cell.per_layer:
            assert callable(load_metric(metric["name"]))


def test_cells_report_what_the_manifest_says():
    cell = load_cell("chr1-pair.query")
    assert [m["name"] for m in cell.end_to_end] == [
        "query_mbp_s", "query_p95_ms", "setup_s"]
    assert all(m["moves"] == "query_mbp_s" for m in cell.per_layer)
    job = load_cell("chr1-pair.job")
    assert [m["name"] for m in job.end_to_end] == ["job_s", "setup_s"]
    assert "device_idle_pct.job" in [m["name"] for m in job.per_layer]


@pytest.fixture
def copy_root(tmp_path):
    """A checkout's benchmark files in a scratch directory."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    return tmp_path


def test_new_files_are_taken_up_without_edits(copy_root):
    before = {p: p.read_bytes() for p in copy_root.rglob("*") if p.is_file()}
    bench = copy_root / "benchmark"
    cfg = json.loads((bench / "configs" / "salmonella10.json").read_text())
    cfg["reference_length"] = 40_000
    (bench / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "both-strands.json").write_text(json.dumps(
        {"kind": "cli_job", "cli_args": ["-b"], "check_share": 0.5}))
    (bench / "traffic" / "kinds" / "echo_job.py").write_text(
        "from benchmark.harness.traffic import Mix\n\n\n"
        "class Kind(Mix):\n    unit = 'echo'\n")
    (bench / "traffic" / "echo.json").write_text(json.dumps(
        {"kind": "echo_job", "check_share": 1.0}))
    (bench / "metrics" / "job.new_reading.py").write_text(
        "def read(run):\n    return 41.5\n")
    m = json.loads((copy_root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny-new", "source": "test",
                         "file": "benchmark/configs/tiny-new.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny-new.both-strands",
                           "config": "tiny-new", "traffic": "both-strands",
                           "chips": 1, "why": "test"})
    m["workloads"].append({"name": "tiny-new.echo", "config": "tiny-new",
                           "traffic": "echo", "chips": 1, "why": "test"})
    next(e for e in m["end_to_end"] if e["name"] == "job_s")[
        "workloads"].append("tiny-new.both-strands")
    m["per_layer"].append({"name": "job.new_reading", "unit": "s",
                           "better": "lower", "source": "host_clock",
                           "layer": "test", "moves": "job_s"})
    # the manifest gains entries; every file that was there is unchanged
    cell = load_cell("tiny-new.both-strands", m, copy_root)
    assert cell.config["reference_length"] == 40_000
    assert cell.traffic["cli_args"] == ["-b"]
    assert [x["name"] for x in cell.end_to_end] == ["job_s", "setup_s"]
    # no workloads key: in every cell that reports the metric it moves
    assert "job.new_reading" in [x["name"] for x in cell.per_layer]
    assert "job.new_reading" not in [
        x["name"] for x in load_cell("chr1-pair.query", m,
                                     copy_root).per_layer]
    assert load_metric("job.new_reading", copy_root)(None) == 41.5
    # a mix of a new kind: the kind's file is found by its name
    echo = load_cell("tiny-new.echo", m, copy_root)
    kind = load_kind(echo.traffic["kind"], copy_root)
    assert issubclass(kind, Mix) and kind.unit == "echo"
    for p, data in before.items():
        assert p.read_bytes() == data


def test_unknown_workload_names_the_known_ones():
    with pytest.raises(KeyError, match="chr1-pair.job"):
        load_cell("no-such.cell")

"""Port vs JAX package: the host utilities — the brute-force oracle
(``oracle/naive.py``), the phase log (``utils/log.py``, ``-v`` and
``SLAMEM_LOG_JSON=1``) and the trace hook (``utils/profile.py``,
``SLAMEM_TRACE_DIR``).

The oracle is held to ``slamem_tpu.oracle`` on the inputs of
tests/test_oracle.py, exactly. The log's records and the trace file are
checked on the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slamem_tpu import oracle as joracle
from slamem_tpu.io import str_to_codes

from slamem_tpu_torch import oracle
from slamem_tpu_torch.cli.main import main
from slamem_tpu_torch.config import Config
from slamem_tpu_torch.engine.run import run_engine
from slamem_tpu_torch.io.fasta import FastaSet, Sequence, write_fasta
from slamem_tpu_torch.utils import log as log_mod
from slamem_tpu_torch.utils.log import PhaseLog
from slamem_tpu_torch.utils.synth import mutate, random_genome, with_n_runs

# the replicated engine's stage records
STAGES = ("upload", "tables", "frontend", "expand", "merge", "extend")

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

# tests/test_oracle.py's string cases: (ref, query, L)
STRING_CASES = [("ACGTACGT", "ACGTACGT", 8), ("ACGTAAAA", "TTTTACGT", 5),
                ("ACGTC", "GGACGTCGG", 4), ("AANAA", "AANAA", 5),
                ("AANAA", "AANAA", 2), ("ACGTTACGTTCCCCCG", "ACGTTCCCCC", 5),
                ("AAACCCCCGTTT", "CCCCCGCCCCCG", 6)]


def _random_cases():
    """tests/test_oracle.py::test_against_brute_random's 20 inputs."""
    rng = np.random.default_rng(42)
    for trial in range(20):
        n, m = int(rng.integers(5, 120)), int(rng.integers(5, 120))
        alpha = int(rng.integers(2, 5))
        ref = rng.integers(0, alpha, size=n).astype(np.uint8)
        qry = rng.integers(0, alpha, size=m).astype(np.uint8)
        if trial % 3 == 0:
            ref[rng.integers(0, n, size=max(1, n // 10))] = 4
            qry[rng.integers(0, m, size=max(1, m // 10))] = 4
        yield ref, qry, int(rng.integers(2, 6))


@pytest.mark.parametrize("mode", ["mem", "mum", "mam"])
def test_oracle_equals_jax_oracle(mode):
    cases = [(str_to_codes(r), str_to_codes(q), L)
             for r, q, L in STRING_CASES] + list(_random_cases())
    for ref, qry, L in cases:
        want = joracle.oracle_matches(ref, qry, L, mode)
        assert oracle.oracle_matches(ref, qry, L, mode) == want, (ref, qry)
    assert oracle.count_occurrences(str_to_codes("AAAA"),
                                    str_to_codes("AA")) == 3


def test_oracle_on_a_genome_pair_and_diagonal_ranges():
    """A mutated pair with N runs and a separator: every mode equals the
    JAX oracle's; occurrence counts equal for every listed MEM; disjoint
    diagonal ranges together give the whole scan."""
    ref = with_n_runs(random_genome(900, seed=5), 2, 10, seed=6)
    ref = np.concatenate([ref, [5], ref[100:300]]).astype(np.uint8)
    qry = with_n_runs(mutate(ref[:900], 0.03, 0.003, seed=7), 2, 8, seed=8)
    for mode in ("mem", "mum", "mam"):
        want = joracle.oracle_matches(ref, qry, 12, mode)
        assert oracle.oracle_matches(ref, qry, 12, mode) == want
        assert len(want) > 0
    mems = oracle.find_mems_codes(ref, qry, 12)
    for r, _, ln in mems:
        sub = ref[r:r + ln]
        assert (oracle.count_occurrences(ref, sub)
                == joracle.count_occurrences(ref, sub))
    n, m = ref.size, qry.size
    parts = [oracle.find_mems_codes(ref, qry, 12, range(a, b))
             for a, b in ((-(m - 1), -40), (-40, 300), (300, n))]
    assert sorted(sum(parts, []), key=lambda t: (t[1], t[0])) == mems


def _sets():
    ref = random_genome(3000, seed=31)
    qry = mutate(ref, 0.02, 0.002, seed=32)
    mk = lambda name, c: FastaSet(names=[name], starts=np.array([0]),  # noqa
                                  lengths=np.array([len(c)]), codes=c)
    return mk("R", ref), mk("Q", qry)


def _stages(st: dict) -> list[str]:
    """The replicated engine's stage records of one call, in order (one
    round)."""
    return ["upload", "tables", "frontend", "expand", "merge",
            *(["extend"] if st["stride"] > 1 else [])]


@pytest.mark.parametrize("json_mode", [False, True])
def test_phase_log_records_and_lines(json_mode, monkeypatch, capsys):
    """-v prints one [slamem] line per phase (index build, the engine's
    stages, query, emit), or one JSON object per line with
    SLAMEM_LOG_JSON=1; the query record carries the plan and the roofline
    bytes, and no rate is derived from the bytes."""
    monkeypatch.setenv("SLAMEM_LOG_JSON", "1" if json_mode else "0")
    ref_set, q_set = _sets()
    out = run_engine(ref_set, q_set, Config(min_length=14, verbose=True),
                     device="cpu")
    err = capsys.readouterr().err.strip().splitlines()
    recs = out.stats["phases"]
    st = out.stats["searches"][0]
    names = ["index_build", *_stages(st), "query", "emit"]
    assert [r["phase"] for r in recs] == names
    qi = names.index("query")
    q = recs[qi]
    assert (q["pairs"], q["rounds"], q["seed_k"], q["stride"],
            q["bytes"]) == (st["pairs"], st["rounds"], st["k"],
                            st["stride"], st["bytes_min"])
    assert q["bp"] == len(q_set.codes) and q["seconds"] > 0
    assert recs[-1]["matches"] == out.stats["matches"]
    assert "gb_per_s" not in q and "hbm_fraction" not in q
    if json_mode:
        assert [json.loads(line) for line in err] == recs
    else:
        assert len(err) == len(names)
        assert err[qi].startswith("[slamem] query: ")
        assert f"seed_k={st['k']}" in err[qi] and "t0_ns" not in err[qi]
        assert err[1].startswith("[slamem] upload: ")
    # a fixed clock (0.5 s) makes the record exact: its ends, the Mbp/s of
    # its bp, its bytes as given and no rate derived from them
    log = PhaseLog(enabled=False)
    ticks = iter([2_000_000_000, 2_500_000_000])
    with monkeypatch.context() as mp:
        mp.setattr(log_mod.time, "time_ns", lambda: next(ticks))
        with log.phase("x", bp=5_000_000) as rec:
            rec["bytes"] = 1_675_000_000
    assert log.records == [{"phase": "x", "seconds": 0.5,
                            "t0_ns": 2_000_000_000, "t1_ns": 2_500_000_000,
                            "bp": 5_000_000, "bytes": 1_675_000_000,
                            "mbp_per_s": 10.0}]
    assert capsys.readouterr().err == ""


def _fasta_pair(tmp_path, entries: int = 1):
    """A reference file and a query file of ``entries`` strains."""
    ref = random_genome(2000, seed=33)
    rp, qp = str(tmp_path / "r.fa"), str(tmp_path / "q.fa")
    write_fasta(rp, [Sequence("R", ref)])
    write_fasta(qp, [Sequence(f"Q{i}", mutate(ref, 0.02, 0.002, seed=34 + i))
                     for i in range(entries)])
    return rp, qp


def test_cli_verbose_records_every_span(monkeypatch, tmp_path, capsys):
    """A 2-entry job with -v prints each span of the job once per file or
    call, read to write, each with its ends on the time_ns clock."""
    monkeypatch.setenv("SLAMEM_LOG_JSON", "1")
    rp, qp = _fasta_pair(tmp_path, entries=2)
    out = tmp_path / "a.txt"
    assert main(["-device", "cpu", "-v", "-l", "14", "-o", str(out), rp,
                 qp]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().err.splitlines()
            if line.startswith("{")]
    job = [r for r in recs if r["phase"] not in STAGES]
    stages = recs[6:-4]
    assert [r["phase"] for r in job] == [
        "fasta_read", "fasta_parse", "fasta_read", "fasta_parse",
        "index_build", "join", "query", "emit", "render", "write"]
    assert recs[:6] + recs[-4:] == job
    for r in recs:
        assert r["t0_ns"] <= r["t1_ns"]
        assert r["seconds"] == pytest.approx((r["t1_ns"] - r["t0_ns"]) / 1e9,
                                             abs=1e-6)
    # one after another, in the job's order; the engine's stages one after
    # another inside the query
    assert all(a["t1_ns"] <= b["t0_ns"] for a, b in zip(job, job[1:]))
    by = {r["phase"]: r for r in job}
    assert [r["phase"] for r in stages][:4] == ["upload", "tables",
                                                "frontend", "expand"]
    assert all(a["t1_ns"] <= b["t0_ns"] for a, b in zip(stages, stages[1:]))
    assert (by["join"]["t1_ns"] <= by["query"]["t0_ns"] <= stages[0]["t0_ns"]
            and stages[-1]["t1_ns"] <= by["query"]["t1_ns"])
    size = out.stat().st_size
    assert by["render"]["bytes"] == by["write"]["bytes"] == size
    assert recs[0]["bytes"] == (tmp_path / "r.fa").stat().st_size
    assert (recs[3]["bp"], recs[3]["seqs"]) == (by["query"]["bp"] - 1, 2)
    assert by["join"]["entries"] == 2
    assert by["emit"]["matches"] == len(out.read_text().splitlines()) - 2


def test_run_engine_records_only_its_own_phases(capsys):
    """Two non-verbose calls with no active log: each returns its own
    records, and nothing is printed."""
    ref_set, q_set = _sets()
    cfg = Config(min_length=14)
    a = run_engine(ref_set, q_set, cfg, device="cpu")
    b = run_engine(ref_set, q_set, cfg, device="cpu")
    names = ["index_build", *_stages(a.stats["searches"][0]), "query",
             "emit"]
    for out in (a, b):
        assert [r["phase"] for r in out.stats["phases"]] == names
    assert a.stats["phases"][-1]["t1_ns"] <= b.stats["phases"][0]["t0_ns"]
    assert capsys.readouterr().err == ""
    # under an active log the call's records are its own slice of it
    log = PhaseLog(enabled=False)
    with log.activate():
        with log_mod.span("before"):
            pass
        c = run_engine(ref_set, q_set, cfg, device="cpu")
    assert [r["phase"] for r in log.records] == ["before", *names]
    assert c.stats["phases"] == log.records[1:]
    assert log_mod.active_log() is None
    with log_mod.span("none", bp=3) as rec:
        assert rec == {"bp": 3}


def test_off_path_makes_no_sync_and_no_profiler_call(monkeypatch, tmp_path,
                                                      capsys):
    """Without -v and with no profiler running, a job's engine stages do
    not wait for the device and nothing calls into the profiler; with -v
    every stage waits."""
    from torch.autograd import profiler as autograd_profiler

    from slamem_tpu_torch.utils import device

    syncs = []
    monkeypatch.setattr(device, "synchronize", syncs.append)

    def refuse(*a, **kw):
        raise AssertionError("the profiler was called")

    for mod, attr in ((torch.profiler, "record_function"),
                      (torch.profiler, "profile"),
                      (torch.profiler, "supported_activities"),
                      (autograd_profiler, "record_function"),
                      (autograd_profiler, "kineto_available")):
        monkeypatch.setattr(mod, attr, refuse)
    monkeypatch.delenv("SLAMEM_TRACE_DIR", raising=False)
    rp, qp = _fasta_pair(tmp_path, entries=2)
    argv = ["-device", "cpu", "-l", "14", "-o", str(tmp_path / "a.txt"),
            rp, qp]
    assert main(argv) == 0
    assert syncs == [] and capsys.readouterr().err == ""
    monkeypatch.setenv("SLAMEM_LOG_JSON", "1")
    assert main(["-v", *argv]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().err.splitlines()
            if line.startswith("{")]
    # one wait a stage: upload, tables, frontend, expand, merge, ...
    assert len(syncs) == sum(r["phase"] in STAGES for r in recs) >= 5


def test_no_span_enters_a_profiler_the_program_did_not_start(
        monkeypatch, tmp_path, capsys):
    """Under a profiler the caller started, with -v and SLAMEM_TRACE_DIR
    set, no slamem: range appears, no second profile starts and no trace
    is written; the engine's stages wait for the device."""
    from torch.profiler import ProfilerActivity, profile

    from slamem_tpu_torch.utils import device

    syncs = []
    monkeypatch.setattr(device, "synchronize", syncs.append)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("SLAMEM_TRACE_DIR", str(trace_dir))
    rp, qp = _fasta_pair(tmp_path, entries=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert main(["-device", "cpu", "-l", "14", "-o",
                     str(tmp_path / "a.txt"), rp, qp]) == 0
    names = {e.name for e in prof.events()}
    assert names and not any(n.startswith("slamem:") for n in names)
    assert "job" not in names and "query" not in names
    assert not trace_dir.exists()
    assert len(syncs) >= 5


def test_trace_dir_writes_a_chrome_trace(monkeypatch, tmp_path, capsys):
    """SLAMEM_TRACE_DIR makes the CLI write one torch.profiler Chrome trace
    of the whole job, read to write, which holds every span of the job as
    a slamem: range; without it nothing is written."""
    rp, qp = _fasta_pair(tmp_path, entries=2)
    trace_dir = tmp_path / "trace"
    monkeypatch.delenv("SLAMEM_TRACE_DIR", raising=False)
    assert main(["-device", "cpu", "-o", str(tmp_path / "a.txt"), rp,
                 qp]) == 0
    assert not trace_dir.exists()
    monkeypatch.setenv("SLAMEM_TRACE_DIR", str(trace_dir))
    assert main(["-device", "cpu", "-o", str(tmp_path / "b.txt"), rp,
                 qp]) == 0
    (path,) = trace_dir.glob("*.trace.json")
    assert path.name.startswith("job.")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    spans = {n for n in names if str(n).startswith("slamem:")}
    stages = {n for n in spans if n[len("slamem:"):] in STAGES}
    assert spans - stages == {f"slamem:{n}" for n in (
        "fasta_read", "fasta_parse", "index_build", "join", "query", "emit",
        "render", "write")}
    assert {f"slamem:{n}" for n in ("upload", "tables", "frontend", "expand",
                                    "merge")} <= stages
    # the job's range holds the engine's own "query" range
    assert {"job", "query"} <= names and len(events) > 10
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt"
                                                 ).read_bytes()


def test_port_modules_import_no_profiler():
    """Importing the CLI, the engine's entry, the FASTA reader and the
    log loads nothing of torch's profiler beyond what ``import torch``
    loads, and the log and the CLI load no torch at all."""
    code = (
        "import sys\n"
        "import slamem_tpu_torch.cli.main, slamem_tpu_torch.utils.log\n"
        "import slamem_tpu_torch.utils.profile, slamem_tpu_torch.io.fasta\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'torch']\n"
        "import torch\n"
        "before = set(sys.modules)\n"
        "import slamem_tpu_torch.engine.run, slamem_tpu_torch.report.format\n"
        "new = [m for m in set(sys.modules) - before if 'profil' in m\n"
        "       or 'kineto' in m]\n"
        "assert not new, new\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]

"""Port vs JAX package: the host utilities — the brute-force oracle
(``oracle/naive.py``), the phase log (``utils/log.py``, ``-v`` and
``SLAMEM_LOG_JSON=1``) and the trace hook (``utils/profile.py``,
``SLAMEM_TRACE_DIR``).

The oracle is held to ``slamem_tpu.oracle`` on the inputs of
tests/test_oracle.py, exactly. The log's records and the trace file are
checked on the CPU.
"""

import json

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
from slamem_tpu_torch.utils.log import H100_HBM_GBPS, PhaseLog
from slamem_tpu_torch.utils.synth import mutate, random_genome, with_n_runs

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

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


@pytest.mark.parametrize("json_mode", [False, True])
def test_phase_log_records_and_lines(json_mode, monkeypatch, capsys):
    """-v prints one [slamem] line per phase (index build, query), or one
    JSON object per line with SLAMEM_LOG_JSON=1; the query record carries
    the plan, the roofline bytes and their rate against the H100's."""
    monkeypatch.setenv("SLAMEM_LOG_JSON", "1" if json_mode else "0")
    ref_set, q_set = _sets()
    out = run_engine(ref_set, q_set, Config(min_length=14, verbose=True),
                     device="cpu")
    err = capsys.readouterr().err.strip().splitlines()
    recs = out.stats["phases"]
    assert [r["phase"] for r in recs] == ["index_build", "query"]
    q = recs[1]
    st = out.stats["searches"][0]
    assert (q["pairs"], q["rounds"], q["seed_k"], q["stride"],
            q["bytes"]) == (st["pairs"], st["rounds"], st["k"],
                            st["stride"], st["bytes_min"])
    assert q["bp"] == len(q_set.codes) and q["seconds"] > 0
    # a CPU run derives no device rate from its bytes
    assert "gb_per_s" not in q and "hbm_fraction" not in q
    if json_mode:
        assert [json.loads(line) for line in err] == recs
    else:
        assert len(err) == 2 and err[1].startswith("[slamem] query: ")
        assert f"seed_k={st['k']}" in err[1]
    # on the card the bytes give a rate and its share of the H100's; a
    # fixed clock (0.5 s) makes the derived fields exact
    log = PhaseLog(enabled=False, device_rates=True)
    ticks = iter([2.0, 2.5])
    with monkeypatch.context() as mp:
        mp.setattr(log_mod.time, "perf_counter", lambda: next(ticks))
        with log.phase("x", bp=5_000_000) as rec:
            rec["bytes"] = int(H100_HBM_GBPS * 1e9 / 4)
    assert log.records == [{"phase": "x", "seconds": 0.5, "bp": 5_000_000,
                            "bytes": int(H100_HBM_GBPS * 1e9 / 4),
                            "mbp_per_s": 10.0,
                            "gb_per_s": H100_HBM_GBPS / 2,
                            "hbm_fraction": 0.5}]
    assert capsys.readouterr().err == ""


def test_trace_dir_writes_a_chrome_trace(monkeypatch, tmp_path, capsys):
    """SLAMEM_TRACE_DIR makes the CLI write a torch.profiler Chrome trace of
    the queries; without it nothing is written."""
    ref = random_genome(2000, seed=33)
    rp, qp = str(tmp_path / "r.fa"), str(tmp_path / "q.fa")
    write_fasta(rp, [Sequence("R", ref)])
    write_fasta(qp, [Sequence("Q", mutate(ref, 0.02, 0.002, seed=34))])
    trace_dir = tmp_path / "trace"
    monkeypatch.delenv("SLAMEM_TRACE_DIR", raising=False)
    assert main(["-device", "cpu", "-o", str(tmp_path / "a.txt"), rp,
                 qp]) == 0
    assert not trace_dir.exists()
    monkeypatch.setenv("SLAMEM_TRACE_DIR", str(trace_dir))
    assert main(["-device", "cpu", "-o", str(tmp_path / "b.txt"), rp,
                 qp]) == 0
    (path,) = trace_dir.glob("query.*.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "query" in names and len(events) > 10
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt"
                                                 ).read_bytes()

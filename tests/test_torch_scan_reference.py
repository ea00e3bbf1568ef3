"""The scan engine (``-engine scan``) against the benchmark's plain
reference on seeded random texts.

``benchmark/reference/lcp.py`` is plain torch and reads nothing of the
port: ``index/lcp.py::lcp_adjacent`` must equal its ``lcp_plain``, and
``scan_mode.scan_intervals`` (the CPU lockstep loop) its
``intervals_plain`` at L 12, 20 and 50, exactly, on references with N
runs, separators and a planted repeat at four sizes up to 2^16. End to
end, the configuration ``chr1-pair-scan`` cut to a CPU size lists, through
``-engine scan -device cpu``, the bytes the default engine lists and the
benchmark's reference works out.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness.fasta import write_fasta
from benchmark.inputs.build import make_inputs
from benchmark.reference.lcp import intervals_plain, lcp_plain
from benchmark.reference.listing import expected_listing
from slamem_tpu_torch.cli.main import main
from slamem_tpu_torch.config import Config
from slamem_tpu_torch.engine import scan_mode
from slamem_tpu_torch.index.build import build_index
from slamem_tpu_torch.index.lcp import LCP_WINDOW, lcp_adjacent
from slamem_tpu_torch.io.fasta import FastaSet
from slamem_tpu_torch.utils.log import PhaseLog
from slamem_tpu_torch.utils.synth import (mutate, random_genome,
                                          with_n_runs, with_repeats)

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SIZES = [1_000, 4_099, 20_000, 1 << 16]
REPEAT = 300          # bases of the planted repeat (longer than any L)


def _reference(size: int) -> np.ndarray:
    """``size`` random bases with one planted repeat of REPEAT bases (where
    it fits twice) and three N runs."""
    codes = random_genome(size, seed=size)
    codes = with_repeats(codes, 1, min(REPEAT, size // 3), seed=size + 1)
    return with_n_runs(codes, 3, 17, seed=size + 2)


def _joined(codes: np.ndarray) -> np.ndarray:
    """The reference as three sequences joined by separators."""
    cuts = [0, len(codes) // 3, 2 * len(codes) // 3, len(codes)]
    fs = FastaSet(names=["a", "b", "c"], starts=np.array(cuts[:3]),
                  lengths=np.diff(cuts), codes=codes)
    return fs.with_separators()[0]


@pytest.fixture(scope="module", params=SIZES)
def case(request):
    ref = _reference(request.param)
    index = build_index(_joined(ref), device="cpu")
    qry = with_n_runs(mutate(ref, 0.02, 0.002, seed=request.param + 3), 2,
                      11, seed=request.param + 4)
    return ref, index, qry


def test_lcp_adjacent_equals_lcp_plain(case):
    _, index, _ = case
    got = lcp_adjacent(index.text, index.sa)
    want = lcp_plain(index.text, index.sa, block=777)
    assert torch.equal(got, want)
    # the planted repeat is in what is compared: an LCP past any L below
    assert int(want.max()) > 50


def test_scan_lcp_span_carries_long_pairs_and_launches(case):
    """A scan call on an index with no cached pyramid records ``scan_lcp``
    with the SA rows, the pairs alike on their first LCP_WINDOW characters
    (the planted repeat's among them) and the call's kernel launches (0:
    the CPU takes the plain version)."""
    _, index, qry = case
    fresh = dataclasses.replace(index, derived={})
    with PhaseLog(enabled=False).activate() as log:
        scan_mode.find_scan_matches(fresh, qry,
                                    Config(min_length=20, engine="scan"))
    rec, = [r for r in log.records if r["phase"] == "scan_lcp"]
    want = lcp_plain(index.text, index.sa)
    assert rec["n"] == index.n and rec["launches"] == 0
    assert rec["long_pairs"] == int((want >= LCP_WINDOW).sum()) > 0
    assert "rounds" not in rec and "bytes" not in rec


@pytest.mark.parametrize("L", [12, 20, 50])
def test_scan_intervals_equal_intervals_plain(case, L):
    _, index, qry = case
    lo, w = scan_mode.scan_intervals(index, qry, L)
    plo, pw = intervals_plain(index.text, index.sa, torch.from_numpy(qry), L,
                              block=1_000)
    assert torch.equal(w, pw)
    hit = pw > 0
    assert torch.equal(lo[hit], plo[hit])
    assert int(hit.sum()) > 0 and int((pw > 1).sum()) > 0


def test_intervals_plain_marks_absent_windows():
    """Windows with a special, windows past the query's end and a window
    that occurs nowhere read width 0; a window that occurs once reads its
    row."""
    ref = random_genome(500, seed=11)
    index = build_index(ref, device="cpu")
    absent = np.array([0] * 6 + [3] * 6, np.uint8)
    assert absent.tobytes() not in ref.tobytes()
    q = np.concatenate([ref[100:130], np.array([4], np.uint8), absent,
                        ref[7:20]])
    lo, w = intervals_plain(index.text, index.sa, torch.from_numpy(q), 12)
    # 0..18 in ref[100:130], 19..30 hold the N, 31 the absent window,
    # 43..44 in ref[7:20], 45.. run past the end
    hits = [*range(19), 43, 44]
    assert (w[hits] >= 1).all()
    assert int(w.sum()) == int(w[hits].sum())
    assert index.sa[int(lo[0])] == 100 and int(w[0]) == 1


@pytest.fixture(scope="module")
def scan_cell_files(tmp_path_factory):
    """``chr1-pair-scan``'s recipe at the CPU size of the chr1 pair in
    ``benchmark/tests/conftest.py``: its FASTA files and the listing the
    benchmark's reference works out."""
    config = json.loads((REPO / "benchmark" / "configs" /
                         "chr1-pair-scan.json").read_text())
    config.update(reference_length=120_000, query_length=30_000)
    cpu = torch.device("cpu")
    inputs = make_inputs(config, 2**31 + 9, cpu)
    tmp = tmp_path_factory.mktemp("scan_cell")
    rp, qp = str(tmp / "ref.fa"), str(tmp / "qry.fa")
    write_fasta(rp, inputs.ref_names, inputs.refs)
    write_fasta(qp, inputs.query_names, inputs.queries)
    want, n_mems = expected_listing(
        inputs.ref_names, inputs.refs, inputs.query_names, inputs.queries,
        int(config["min_length"]), cpu)
    return tmp, rp, qp, int(config["min_length"]), want, n_mems


@pytest.mark.parametrize("engine", ["scan", "seed"])
def test_scan_cell_lists_what_the_reference_lists(scan_cell_files, engine):
    tmp, rp, qp, L, want, n_mems = scan_cell_files
    out = tmp / f"{engine}.txt"
    assert main(["-l", str(L), "-engine", engine, "-device", "cpu", "-o",
                 str(out), rp, qp]) == 0
    assert out.read_text() == want and n_mems > 0

"""The port's virtual-slab program (``-shard -slabs n`` on one device)
against the benchmark's plain reference, and its spans.

``benchmark/reference/mems.py`` is plain torch and imports nothing of the
port or of JAX: ``run_engine`` with ``shard_index=True`` must list exactly
the MEMs it lists, at slab counts 2, 3 and 8, with per-slab direct tables
(probes 0) and with bracket-and-refine (probes > 0). A small table budget
(``max_table_bytes``) keeps the ranged tables of K >= 15 small on the CPU,
as ``tests/test_torch_sharded.py`` does.

A CLI job records the program's stages as spans of its PhaseLog inside
``query``: ``upload``, ``slab_tables``, ``slab_frontend``, per round
``slab_expand`` and ``slab_merge``, then the tail's ``merge`` and
``extend``, with their fields. Without ``-v`` the records add no
synchronise and no host read.

Every engine's stages (the replicated engine dense, sparse, at several
rounds, on the boundary backend and given a one-rank mesh, the slab
program, the scan engine) tile its call: the records follow one another, and ``stats['stage_s']``
is their seconds summed by name. The replicated engine's host reads are
pinned as the slab program's are, and under ``cfg.verbose`` each of its
stages waits for the device once.
"""

import functools
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference.mems import ReferenceTable
from slamem_tpu_torch.cli.main import main
from slamem_tpu_torch.config import Config
from slamem_tpu_torch.dist import sharded
from slamem_tpu_torch.dist.mesh import make_mesh
from slamem_tpu_torch.engine import scan_mode, seed_mode
from slamem_tpu_torch.engine.run import run_engine
from slamem_tpu_torch.index.build import build_index
from slamem_tpu_torch.io.fasta import FastaSet, Sequence, write_fasta
from slamem_tpu_torch.kernels.rank import nibble_rows
from slamem_tpu_torch.utils import device
from slamem_tpu_torch.utils.log import PhaseLog
from slamem_tpu_torch.utils.synth import mutate, random_genome, with_n_runs

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BUDGET = 1 << 20
SLAB_SPANS = ("slab_tables", "slab_frontend", "slab_expand", "slab_merge")
# the slab program's stage records at -l 14 (stride 7): its spans between
# the upload and the device tail
SLAB_STAGES = ("upload", *SLAB_SPANS, "merge", "extend")


def _set(name: str, codes: np.ndarray) -> FastaSet:
    return FastaSet(names=[name], starts=np.array([0]),
                    lengths=np.array([len(codes)]), codes=codes)


@pytest.fixture(scope="module")
def pair():
    ref = with_n_runs(random_genome(12_000, seed=601), 2, 40, seed=602)
    qry = with_n_runs(mutate(ref, 0.02, 0.002, seed=603), 2, 30, seed=604)
    return ref, qry


@pytest.fixture
def small_tables(monkeypatch):
    monkeypatch.setattr(sharded, "virtual_slab_tables", functools.partial(
        sharded.virtual_slab_tables, max_table_bytes=BUDGET))


def _reference(ref: np.ndarray, qry: np.ndarray, min_len: int):
    r, q, n = ReferenceTable(torch.from_numpy(ref), min_len).find_mems(
        torch.from_numpy(qry))
    return sorted(zip(r.tolist(), q.tolist(), n.tolist()))


def _listed(out) -> list[tuple[int, int, int]]:
    (qm,) = out.per_query
    return sorted(zip(qm.ref_pos.tolist(), qm.q_pos.tolist(),
                      qm.length.tolist()))


# min_length -> whether the plan probes: K 8 at -l 14 keeps each slab's
# table direct; K 16 at -l 30 coarsens the buckets under the budget
PROBES = {14: False, 30: True}


@pytest.mark.parametrize("min_len", sorted(PROBES))
@pytest.mark.parametrize("n_slabs", [2, 3, 8])
def test_slab_program_lists_what_the_reference_lists(pair, small_tables,
                                                     n_slabs, min_len):
    ref, qry = pair
    cfg = Config(min_length=min_len, shard_index=True, shard_slabs=n_slabs)
    out = run_engine(_set("R", ref), _set("Q", qry), cfg, device="cpu")
    (st,) = out.stats["searches"]
    assert st["shards"] == n_slabs and st["virtual_slabs"] is True
    assert (st["probes"] > 0) == PROBES[min_len]
    want = _reference(ref, qry, min_len)
    assert _listed(out) == want and len(want) > 0


def _slab_records(records: list[dict]) -> dict[str, list[dict]]:
    by = {name: [] for name in SLAB_SPANS}
    for r in records:
        if r["phase"] in by:
            by[r["phase"]].append(r)
    return by


def test_cli_job_records_the_slab_spans_inside_query(pair, monkeypatch,
                                                     tmp_path, capsys):
    """One -shard -slabs 8 job with -v and the JSON log: the four spans
    inside ``query``, in the program's order, with their fields."""
    ref, qry = pair
    rp, qp = str(tmp_path / "r.fa"), str(tmp_path / "q.fa")
    write_fasta(rp, [Sequence("R", ref)])
    write_fasta(qp, [Sequence("Q", qry)])
    monkeypatch.setenv("SLAMEM_LOG_JSON", "1")
    out = tmp_path / "a.txt"
    assert main(["-device", "cpu", "-v", "-shard", "-slabs", "8", "-l",
                 "14", "-o", str(out), rp, qp]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().err.splitlines()
            if line.startswith("{")]
    assert [r["phase"] for r in recs] == [
        "fasta_read", "fasta_parse", "fasta_read", "fasta_parse",
        "index_build", *SLAB_STAGES, "query", "emit", "render", "write"]
    by = {r["phase"]: r for r in recs}
    query = by["query"]
    stages = recs[5:5 + len(SLAB_STAGES)]
    assert all(query["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= query["t1_ns"]
               for r in stages)
    assert all(a["t1_ns"] <= b["t0_ns"] for a, b in zip(stages, stages[1:]))
    assert sum(r["seconds"] for r in stages) <= query["seconds"]
    tables, front, expand, merge = stages[1:5]
    assert tables["slabs"] == 8 and tables["rows"] % 8 == 0
    assert tables["rows"] >= len(ref) + 1
    assert tables["R"] >= 2 and tables["R"] & (tables["R"] - 1) == 0
    assert (tables["shift"], tables["probes"]) == (0, 0)
    assert front["windows"] > 0 and len(front["slab_pairs"]) == 8
    assert expand["round"] == 0 and expand["rounds"] == query["rounds"] == 1
    assert expand["pairs"] == sum(front["slab_pairs"]) >= query["pairs"] > 0
    assert expand["worst_slab_pairs"] == max(front["slab_pairs"])
    assert expand["worst_slab_pairs"] * 8 >= expand["pairs"]
    assert expand["busy_slabs"] == sum(p > 0 for p in front["slab_pairs"])
    assert merge["round"] == 0 and merge["runs"] >= by["emit"]["matches"]


@pytest.mark.parametrize("n_slabs", [2, 3, 8])
@pytest.mark.parametrize("capacity", [None, 100])
def test_worst_slab_pairs_bounds_each_rounds_share(pair, small_tables,
                                                   n_slabs, capacity):
    """Under an active log (run_engine's own, in stats['phases']) each
    round records one ``slab_expand`` and one ``slab_merge``; the worst
    slab's pairs are at least the slabs' mean."""
    ref, qry = pair
    fields = {} if capacity is None else {"pair_capacity": capacity}
    cfg = Config(min_length=14, shard_index=True, shard_slabs=n_slabs,
                 **fields)
    out = run_engine(_set("R", ref), _set("Q", qry), cfg, device="cpu")
    (st,) = out.stats["searches"]
    by = _slab_records(out.stats["phases"])
    rounds = st["rounds"]
    assert (rounds > 1) == (capacity is not None)
    assert [r["round"] for r in by["slab_expand"]] == list(range(rounds))
    assert [r["round"] for r in by["slab_merge"]] == list(range(rounds))
    assert len(by["slab_tables"]) == len(by["slab_frontend"]) == 1
    for r in by["slab_expand"]:
        assert r["rounds"] == rounds and r["pairs"] >= st["pairs"] > 0
        assert r["worst_slab_pairs"] >= r["pairs"] / n_slabs
        assert r["busy_slabs"] <= n_slabs
    assert by["slab_tables"][0]["R"] == st["R"]
    assert (by["slab_tables"][0]["shift"], by["slab_tables"][0]["probes"]
            ) == (st["shift"], st["probes"])


def _host_touches(mp) -> list[str]:
    """Every synchronise of the engine and every read of a tensor to the
    host (``.cpu()``, ``.numpy()``, ``.item()``, ``.tolist()``, ``int()``,
    ``bool()``), by name, as it happens, while ``mp`` (a monkeypatch
    context) lasts."""
    seen = []
    mp.setattr(device, "synchronize",
               lambda dev: seen.append("synchronize"))
    for attr in ("cpu", "numpy", "item", "tolist", "__int__", "__bool__"):
        orig = getattr(torch.Tensor, attr)

        def counted(self, *a, _orig=orig, _attr=attr, **kw):
            seen.append(_attr)
            return _orig(self, *a, **kw)

        mp.setattr(torch.Tensor, attr, counted)
    return seen


# The slab program's host reads on the CPU before it had spans, in order:
# the query's upload (its wire's two numpy views), the slab plan's one
# read, the plain bucket tables' ends (one int a slab), the frontend
# summary, at several rounds the worst-slab cumsum, the tail's one fetch
# of the matches, the pair count
_TABLE_READS = ["numpy", "numpy", "cpu", "numpy", *["__int__"] * 8]
READS = {None: [*_TABLE_READS, "cpu", "numpy", "cpu", "numpy", "__int__"],
         100: [*_TABLE_READS, "cpu", "numpy", "cpu", "numpy", "cpu", "numpy",
               "__int__"]}


@pytest.mark.parametrize("capacity", sorted(READS, key=str))
def test_slab_records_add_no_sync_and_no_host_read(pair, monkeypatch,
                                                   capacity):
    """With the log off (not verbose, no profiler) a query that records
    the four spans makes no synchronise, and reads from the device what
    the program read before it had spans, at one round and at several."""
    ref, qry = pair
    fields = {} if capacity is None else {"pair_capacity": capacity}
    cfg = Config(min_length=14, **fields)
    index = build_index(_set("R", ref).with_separators()[0], cfg.occ_block,
                        "cpu")
    with PhaseLog(enabled=False).activate() as log, \
            monkeypatch.context() as mp:
        seen = _host_touches(mp)
        m = sharded.find_seed_matches_sharded(index, qry, cfg, n_slabs=8)
    assert set(r["phase"] for r in log.records) == set(SLAB_STAGES)
    assert (m.stats["rounds"] > 1) == (capacity is not None)
    assert seen == READS[capacity] and m.refpos.size > 0


def _slabs8(index, qry, cfg):
    return sharded.find_seed_matches_sharded(index, qry, cfg, n_slabs=8)


def _mesh1(index, qry, cfg):
    return seed_mode.find_seed_matches(index, qry, cfg, make_mesh(1, "cpu"))


_REPLICATED = ("upload", "tables", "frontend", "expand", "merge")
# case -> (engine entry, Config fields, its stage names)
ENGINES = {
    "dense": (seed_mode.find_seed_matches,
              dict(min_length=14, sparse_seeds="off"), _REPLICATED),
    "sparse": (seed_mode.find_seed_matches, dict(min_length=14),
               (*_REPLICATED, "extend")),
    "rounds": (seed_mode.find_seed_matches,
               dict(min_length=14, pair_capacity=100),
               (*_REPLICATED, "extend")),
    "boundary": (seed_mode.find_seed_matches,
                 dict(min_length=14, match_backend="boundary"), _REPLICATED),
    "slabs8": (_slabs8, dict(min_length=14), SLAB_STAGES),
    "mesh1": (_mesh1, dict(min_length=14),
              (*_REPLICATED, "gather", "extend")),
    "scan": (scan_mode.find_scan_matches, dict(min_length=14, engine="scan"),
             ("upload", "scan_lcp", "scan_rows", "frontend", "expand",
              "merge")),
}
# stages a call records only on an index that has not cached what they
# build: the scan engine's LCP array and occ table
COLD_STAGES = {"scan": ("scan_lcp", "scan_rows")}


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_stage_s_sums_the_calls_abutting_stage_records(pair, small_tables,
                                                       case):
    """Under an active log every record of an engine call is one of its
    stages, each opening after the one before closed (the slab program
    plans K and its rounds between two stages); ``stage_s`` holds each
    stage's records summed, and nothing else. With no active log the call
    records into a log of its own and reports the same stages."""
    ref, qry = pair
    fn, fields, names = ENGINES[case]
    cfg = Config(**fields)
    index = build_index(_set("R", ref).with_separators()[0], cfg.occ_block,
                        "cpu")
    with PhaseLog(enabled=False).activate() as log:
        m = fn(index, qry, cfg)
    recs = log.records
    assert recs[0]["phase"] == "upload" and m.refpos.size > 0
    assert {r["phase"] for r in recs} == set(names)
    assert all(a["t1_ns"] <= b["t0_ns"] for a, b in zip(recs, recs[1:]))
    st = m.stats["stage_s"]
    assert st == {n: sum(r["seconds"] for r in recs if r["phase"] == n)
                  for n in names}
    assert (m.stats["rounds"] > 1) == (case == "rounds")
    cold = COLD_STAGES.get(case, ())
    if cold:
        assert [r["phase"] for r in recs[:4]] == ["upload", *cold,
                                                  "frontend"]
    assert set(fn(index, qry, cfg).stats["stage_s"]) == set(names) - set(
        cold)


# The replicated engine's host reads on the CPU before its stages were
# spans, in order, its tables cached: the query's upload (its wire's two
# numpy views), the pair total, at several rounds the width cumsum, the
# tail's one fetch of the matches
REPLICATED_READS = {None: ["numpy", "numpy", "__int__", "cpu", "numpy"],
                    100: ["numpy", "numpy", "__int__", "cpu", "numpy",
                          "cpu", "numpy"]}


@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("capacity", sorted(REPLICATED_READS, key=str))
def test_replicated_stages_add_no_sync_and_no_host_read(pair, monkeypatch,
                                                        capacity, verbose):
    """With the log off (not verbose, no profiler) the replicated engine's
    stages make no synchronise, and it reads from the device what it read
    before its stages were spans, at one round and at several; with
    ``cfg.verbose`` each stage record waits for the device once, and the
    reads are the same."""
    ref, qry = pair
    fields = {} if capacity is None else {"pair_capacity": capacity}
    cfg = Config(min_length=14, verbose=verbose, **fields)
    index = build_index(_set("R", ref).with_separators()[0], cfg.occ_block,
                        "cpu")
    seed_mode.find_seed_matches(index, qry, cfg)   # the tables, cached
    with PhaseLog(enabled=False).activate() as log, \
            monkeypatch.context() as mp:
        seen = _host_touches(mp)
        m = seed_mode.find_seed_matches(index, qry, cfg)
    assert (m.stats["rounds"] > 1) == (capacity is not None)
    assert [x for x in seen if x != "synchronize"] == REPLICATED_READS[
        capacity]
    assert seen.count("synchronize") == (len(log.records) if verbose else 0)
    assert [r["phase"] for r in log.records] == [*_REPLICATED, "extend"]


@pytest.mark.parametrize("verbose", [False, True])
def test_scan_stages_add_no_sync_and_no_host_read(pair, monkeypatch,
                                                  verbose):
    """A cold scan call reads from the device what building the LCP
    pyramid and the nibble table outside any stage reads plus what a warm
    call reads; with the log off it makes no synchronise, and under
    ``cfg.verbose`` each stage record waits for the device once. A warm
    call records neither cold stage."""
    ref, qry = pair
    cfg = Config(min_length=14, engine="scan", verbose=verbose)
    text = _set("R", ref).with_separators()[0]
    cold, warm = (build_index(text, cfg.occ_block, "cpu") for _ in range(2))
    with PhaseLog(enabled=False).activate() as log, \
            monkeypatch.context() as mp:
        seen = _host_touches(mp)
        m = scan_mode.find_scan_matches(cold, qry, cfg)
    with monkeypatch.context() as mp:
        tables = _host_touches(mp)
        scan_mode.get_pyramid(warm)
        nibble_rows(warm)
    with PhaseLog(enabled=False).activate() as warm_log, \
            monkeypatch.context() as mp:
        again = _host_touches(mp)
        m2 = scan_mode.find_scan_matches(warm, qry, cfg)
    assert [r["phase"] for r in log.records][:4] == [
        "upload", "scan_lcp", "scan_rows", "frontend"]
    assert not {"scan_lcp", "scan_rows"} & {
        r["phase"] for r in warm_log.records}
    reads = [x for x in seen if x != "synchronize"]
    assert Counter(reads) == Counter(tables) + Counter(
        x for x in again if x != "synchronize")
    assert seen.count("synchronize") == (len(log.records) if verbose else 0)
    assert again.count("synchronize") == (len(warm_log.records) if verbose
                                          else 0)
    assert _listed_matches(m) == _listed_matches(m2) and m.refpos.size > 0


def _listed_matches(m) -> list[tuple[int, int, int]]:
    return sorted(zip(m.refpos.tolist(), m.qpos.tolist(),
                      m.length.tolist()))


def test_reference_and_slab_program_load_no_jax(tmp_path):
    """The reference and the slab program in a process of their own: the
    same listing, and no JAX or JAX package module loaded."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from benchmark.reference.mems import ReferenceTable\n"
        "from slamem_tpu_torch.config import Config\n"
        "from slamem_tpu_torch.engine.run import run_engine\n"
        "from slamem_tpu_torch.io.fasta import FastaSet\n"
        "from slamem_tpu_torch.utils.synth import mutate, random_genome\n"
        "ref = random_genome(3000, seed=7)\n"
        "qry = mutate(ref, 0.02, 0.002, seed=8)\n"
        "mk = lambda c: FastaSet(names=['x'], starts=np.array([0]),\n"
        "                        lengths=np.array([len(c)]), codes=c)\n"
        "out = run_engine(mk(ref), mk(qry), Config(min_length=14,\n"
        "                 shard_index=True, shard_slabs=3), device='cpu')\n"
        "(qm,) = out.per_query\n"
        "got = sorted(zip(qm.ref_pos.tolist(), qm.q_pos.tolist(),\n"
        "                 qm.length.tolist()))\n"
        "r, q, n = ReferenceTable(torch.from_numpy(ref), 14).find_mems(\n"
        "    torch.from_numpy(qry))\n"
        "assert got == sorted(zip(r.tolist(), q.tolist(), n.tolist()))\n"
        "assert got\n"
        "bad = {m.split('.')[0] for m in sys.modules} & {\n"
        "    'jax', 'jaxlib', 'flax', 'slamem_tpu'}\n"
        "assert not bad, bad\n"
        "print('ok', len(got))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok ")

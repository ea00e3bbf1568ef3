"""Engine orchestration: FASTA sets -> per-query match listings (port of
``slamem_tpu/engine/run.py``).

Load reference → build index → for each query sequence (and strand with -b)
→ search → filter → report, with the search itself delegated to the seed
engine (the default; ``-shard`` runs its sharded form,
``dist/sharded.py``, and a mesh of several ranks runs it over the ranks,
``dist/``) or the scan engine (``Config.engine``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from slamem_tpu_torch.config import Config
from slamem_tpu_torch.dist.mesh import Mesh
from slamem_tpu_torch.dist.sharded import find_seed_matches_sharded
from slamem_tpu_torch.engine import scan_mode, seed_mode
from slamem_tpu_torch.index.build import (FMIndex, build_index,
                                          occ_checkpoints, suffix_array)
from slamem_tpu_torch.io.fasta import FastaSet, revcomp_codes
from slamem_tpu_torch.utils.device import resolve_device, synchronize
from slamem_tpu_torch.utils.log import call_log
from slamem_tpu_torch.utils.profile import maybe_trace


@dataclasses.dataclass
class QueryMatches:
    """Matches of one query sequence on one strand, in reporting coordinates.

    Positions are 0-based here; the formatter adds the reference's 1-based
    convention at the last moment (report/format.py).
    """

    query_name: str
    reverse: bool
    ref_seq: np.ndarray   # int: index into EngineOutput.ref_names
    ref_pos: np.ndarray   # 0-based position within that reference sequence
    q_pos: np.ndarray     # 0-based position within the (strand-adjusted) query
    length: np.ndarray


@dataclasses.dataclass
class EngineOutput:
    ref_names: list[str]
    per_query: list[QueryMatches]
    stats: dict


def _search_one(index: FMIndex, qcodes: np.ndarray, cfg: Config,
                mesh: Mesh | None = None) -> seed_mode.SeedMatches:
    if cfg.engine == "seed":
        # -shard on a mesh, or with more than one slab, runs the sharded
        # engine (one slab per rank; the virtual-slab program on one rank);
        # -shard alone on one device and -slabs without -shard run the
        # replicated engine, as the JAX package does
        if cfg.shard_index and (mesh is not None
                                or (cfg.shard_slabs or 1) > 1):
            return find_seed_matches_sharded(index, qcodes, cfg, mesh,
                                             n_slabs=cfg.shard_slabs)
        return seed_mode.find_seed_matches(index, qcodes, cfg, mesh=mesh)
    if cfg.engine == "scan":
        if mesh is not None:
            raise ValueError(
                "-engine scan is the single-device parity engine; it does "
                "not support -shard or multi-process meshes (use the "
                "default seed engine)")
        return scan_mode.find_scan_matches(index, qcodes, cfg)
    raise ValueError(f"unknown engine {cfg.engine!r}")


def run_engine(ref_set: FastaSet, query_set: FastaSet, cfg: Config,
               index: FMIndex | None = None, mesh: Mesh | None = None,
               device: str | torch.device = "cuda") -> EngineOutput:
    """Search every query sequence (both strands with -b) on ``device``
    (the card unless the caller asks for the CPU; a given ``index`` must
    lie there).

    ``mesh`` (dist/mesh.py) runs the seed engine over its ranks; every rank
    calls run_engine with the same inputs and gets the same output. Its
    phases (``index_build``, ``join``, ``query``, ``emit``, and the
    engine's own spans inside ``query``) go to the active PhaseLog
    (utils/log.py), or to a log of this call's own, which prints them with
    ``cfg.verbose``; ``stats['phases']`` holds this call's records.
    ``SLAMEM_TRACE_DIR`` traces the queries (utils/profile.py).
    """
    dev = resolve_device(device)
    log = call_log(cfg.verbose)
    n_records = len(log.records)
    t0 = time.perf_counter()
    rtext, rstarts = ref_set.with_separators()
    with log.phase("index_build", bp=len(rtext)) as rec:
        launches = occ_checkpoints.launches
        sorts = suffix_array.sorts
        if index is None:
            index = build_index(rtext, cfg.occ_block, dev)
        elif index.device != dev:
            raise ValueError(f"index is on {index.device}, run asked for "
                             f"{dev}")
        rec["occ_launches"] = occ_checkpoints.launches - launches
        rec["sa_sorts"] = suffix_array.sorts - sorts
        synchronize(dev)
    t_build = time.perf_counter() - t0

    per_query: list[QueryMatches] = []
    searches: list[dict] = []   # stats of each engine call
    total = 0
    qbp = 0
    strands = [False, True] if cfg.both_strands else [False]

    def _emit(qi: int, rev: bool, m, qoff: int) -> None:
        nonlocal total
        # emission order is (qpos, refpos)
        order = seed_mode._sort_diag_qstart(m.qpos, m.refpos)
        refpos, qpos, length = (m.refpos[order], m.qpos[order] - qoff,
                                m.length[order])
        seq_id, local = ref_set.locate_in_text(refpos, rstarts)
        per_query.append(QueryMatches(
            query_name=query_set.names[qi], reverse=rev,
            ref_seq=seq_id, ref_pos=local, q_pos=qpos, length=length))
        total += int(length.size)

    def _search(qcodes: np.ndarray, **fields):
        with log.phase("query", bp=len(qcodes), **fields) as rec, \
                log.activate():
            m = _search_one(index, qcodes, cfg, mesh)
            st = m.stats
            rec.update(pairs=st["pairs"], rounds=st["rounds"],
                       seed_k=st["k"], stride=st["stride"])
            if "bytes_min" in st:
                rec["bytes"] = st["bytes_min"]
        searches.append(st)
        return m

    t1 = time.perf_counter()
    with maybe_trace("query"):
        if query_set.num_seqs > 1 or cfg.both_strands:
            # Every (sequence, strand) combination joins into ONE
            # separator-delimited text — a single engine call for the whole
            # request. MUM/MAM uniqueness is per (sequence, strand), so the
            # containment filter runs on each entry's slice, whose
            # query-coordinate range is disjoint from every other entry's.
            entries = [(qi, rev) for qi in range(query_set.num_seqs)
                       for rev in strands]
            with log.phase("join", entries=len(entries)):
                parts = []
                for qi, rev in entries:
                    codes = query_set.sequence(qi).codes
                    parts.append(revcomp_codes(codes) if rev else codes)
                lengths = np.array([len(p) for p in parts], dtype=np.int64)
                joined = FastaSet(
                    names=[f"{qi}/{rev}" for qi, rev in entries],
                    starts=np.concatenate(([0], np.cumsum(lengths)[:-1])),
                    lengths=lengths, codes=np.concatenate(parts))
                qtext, qstarts = joined.with_separators()
            qbp += int(query_set.lengths.sum()) * len(strands)
            m = _search(qtext, entries=len(entries))
            with log.phase("emit") as rec:
                entry_of_match = np.searchsorted(qstarts, m.qpos,
                                                 side="right") - 1
                for e, (qi, rev) in enumerate(entries):  # ref emission order
                    sel = entry_of_match == e
                    sub = seed_mode.apply_mode_filter(seed_mode.SeedMatches(
                        m.refpos[sel], m.qpos[sel], m.length[sel]), cfg)
                    _emit(qi, rev, sub, int(qstarts[e]))
                rec["matches"] = total
        else:
            for qi in range(query_set.num_seqs):
                qcodes = query_set.sequence(qi).codes
                qbp += len(qcodes)
                m = _search(qcodes, seq=query_set.names[qi], reverse=False)
                with log.phase("emit") as rec:
                    _emit(qi, False, seed_mode.apply_mode_filter(m, cfg), 0)
                    rec["matches"] = total
        synchronize(dev)
    t_query = time.perf_counter() - t1
    stats = {
        "index_build_s": t_build,
        "query_s": t_query,
        "query_bp": qbp,
        "matches": total,
        "query_mbp_per_s": (qbp / 1e6) / t_query if t_query > 0 else 0.0,
        "device": str(dev),
        "searches": searches,
        "phases": log.records[n_records:],
    }
    return EngineOutput(ref_names=ref_set.names, per_query=per_query,
                        stats=stats)

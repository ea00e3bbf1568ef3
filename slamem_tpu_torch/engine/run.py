"""Engine orchestration: FASTA sets -> per-query match listings (port of
``slamem_tpu/engine/run.py``).

Load reference → build index → for each query sequence (and strand with -b)
→ search → filter → report. The scan engine is ported; the seed engine is
not yet (ROADMAP A3).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from slamem_tpu_torch.config import Config
from slamem_tpu_torch.engine import scan_mode, seed_mode
from slamem_tpu_torch.index.build import FMIndex, build_index
from slamem_tpu_torch.io.fasta import FastaSet, revcomp_codes
from slamem_tpu_torch.utils.device import resolve_device, synchronize


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


def _search_one(index: FMIndex, qcodes: np.ndarray,
                cfg: Config) -> seed_mode.SeedMatches:
    if cfg.engine == "scan":
        return scan_mode.find_scan_matches(index, qcodes, cfg)
    if cfg.engine == "seed":
        raise NotImplementedError(
            "the seed engine is not ported yet (ROADMAP A3: seed frontend "
            "and fused tail); use engine='scan'")
    raise ValueError(f"unknown engine {cfg.engine!r}")


def run_engine(ref_set: FastaSet, query_set: FastaSet, cfg: Config,
               device: str | torch.device,
               index: FMIndex | None = None) -> EngineOutput:
    """Search every query sequence (both strands with -b) on ``device``."""
    dev = resolve_device(device)
    if cfg.shard_index:
        raise NotImplementedError(
            "index sharding is not ported yet (ROADMAP A8: index sharding)")
    t0 = time.perf_counter()
    rtext, rstarts = ref_set.with_separators()
    if index is None:
        index = build_index(rtext, cfg.occ_block, dev)
    elif index.device != dev:
        raise ValueError(f"index is on {index.device}, run asked for {dev}")
    synchronize(dev)
    t_build = time.perf_counter() - t0

    per_query: list[QueryMatches] = []
    total = 0
    qbp = 0
    t1 = time.perf_counter()
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

    if query_set.num_seqs > 1 or cfg.both_strands:
        # Every (sequence, strand) combination joins into ONE
        # separator-delimited text — a single engine call for the whole
        # request. MUM/MAM uniqueness is per (sequence, strand), so the
        # containment filter runs on each entry's slice, whose
        # query-coordinate range is disjoint from every other entry's.
        entries = [(qi, rev) for qi in range(query_set.num_seqs)
                   for rev in strands]
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
        m = _search_one(index, qtext, cfg)
        entry_of_match = np.searchsorted(qstarts, m.qpos, side="right") - 1
        for e, (qi, rev) in enumerate(entries):  # ref emission order
            sel = entry_of_match == e
            sub = seed_mode.apply_mode_filter(seed_mode.SeedMatches(
                m.refpos[sel], m.qpos[sel], m.length[sel]), cfg)
            _emit(qi, rev, sub, int(qstarts[e]))
    else:
        for qi in range(query_set.num_seqs):
            qcodes = query_set.sequence(qi).codes
            qbp += len(qcodes)
            m = seed_mode.apply_mode_filter(_search_one(index, qcodes, cfg),
                                            cfg)
            _emit(qi, False, m, 0)
    synchronize(dev)
    t_query = time.perf_counter() - t1
    stats = {
        "index_build_s": t_build,
        "query_s": t_query,
        "query_bp": qbp,
        "matches": total,
        "query_mbp_per_s": (qbp / 1e6) / t_query if t_query > 0 else 0.0,
        "device": str(dev),
    }
    return EngineOutput(ref_names=ref_set.names, per_query=per_query,
                        stats=stats)

"""Shared pair/run backend of the MEM engines (port of the backend subset of
``slamem_tpu/engine/seed_mode.py``).

Per-position SA intervals at depth k become maximal matches:

  1. expand intervals into (diagonal, qpos) candidate pairs, in rounds whose
     pair totals fit ``Config.pair_capacity`` (a memory budget);
  2. sort the pairs by (diagonal, qpos) as one packed int64 key;
  3. maximal matches fall out as runs of consecutive qpos on a diagonal:
     a run [a, b] on diagonal c IS the maximal match (c + a, a, K + b - a);
  4. the host merges runs cut by round edges and drops those shorter than
     the minimum length.

Why this is correct:
  * every candidate pair (r, i) satisfies pairLCP(ref[r:], q[i:]) >= K, and
    every pair with pairLCP >= K is produced exactly once;
  * a maximal match of length D >= K contributes pairs at offsets
    o = 0..D-K (windows fully inside the match), i.e. one maximal run;
  * left/right maximality: a pair adjacent to the run (i = a-1 or b+1 on the
    same diagonal) would force the window to match, contradicting run
    maximality, so ref[c+a-1] != q[a-1] and the length is exactly K + b - a;
  * matches of length in [K, L) are dropped by the final length filter.

The seed frontend (K-mer packing, seed tables, the fused tail) is not ported
yet (ROADMAP A3); the scan engine (engine/scan_mode.py) feeds this backend.
Where the JAX package sizes device buffers to fixed capacities for XLA's
static shapes, this port sizes them from the data, so its run-overflow
fallback has nothing to catch and does not exist.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slamem_tpu_torch.config import Config
from slamem_tpu_torch.io.fasta import CODE_N

_I32MAX = int(np.iinfo(np.int32).max)


# ---------------------------------------------------------------------------
# Device side: expansion, pair sort, run compaction
# ---------------------------------------------------------------------------

def _expand_seg(lo: torch.Tensor, width: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged expansion skeleton: per-pair segment id + SA index (int64).

    Pair slot s of segment g (slots base[g] .. base[g]+width[g]-1) points at
    SA row lo[g] + (s - base[g]). Sized from the data: one host read of the
    pair total (inside repeat_interleave).
    """
    w = width.to(torch.int64)
    seg = torch.repeat_interleave(
        torch.arange(w.shape[0], dtype=torch.int64, device=w.device), w)
    base = torch.cumsum(w, 0) - w
    slot = torch.arange(seg.shape[0], dtype=torch.int64, device=w.device)
    return seg, lo.to(torch.int64)[seg] + (slot - base[seg])


def _expand_pairs_core(sa_aug: torch.Tensor, lo: torch.Tensor,
                       width: torch.Tensor, q_start: int, m_off: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged expansion + lexicographic sort.

    Returns int32 (diag_sorted, qpos_sorted): candidate pairs as
    diag' = refpos - qpos + m_off and qpos, sorted by (diag', qpos); pairs
    whose SA row carries the sign-bit invalid flag of ``sa_aug`` become
    (_I32MAX, _I32MAX) and sort last. The two keys pack into one int64,
    diag' in the high word, so one ``torch.sort`` orders them.
    ``q_start`` is the query position of segment 0 (blocks are contiguous).
    """
    seg, sa_idx = _expand_seg(lo, width)
    refpos_f = sa_aug[sa_idx.clamp(0, sa_aug.shape[0] - 1)]
    refpos = (refpos_f & 0x7FFFFFFF).to(torch.int64)
    qp = q_start + seg
    ok = refpos_f >= 0
    d = torch.where(ok, refpos - qp + m_off, _I32MAX)
    q = torch.where(ok, qp, _I32MAX)
    key = torch.sort((d << 32) | q).values
    return (key >> 32).to(torch.int32), (key & 0xFFFFFFFF).to(torch.int32)


def expand_block_pairs(sa_aug: torch.Tensor, lo: torch.Tensor,
                       width: torch.Tensor, start: int, end: int, m_off: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted int32 (diag', qpos) pairs of query positions [start, end)."""
    return _expand_pairs_core(sa_aug, lo[start:end], width[start:end], start,
                              m_off)


def _compact_pair_runs(d_s: torch.Tensor, q_s: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted (diag, qpos) pairs -> run boundary triples (run_d, run_qs,
    run_qe), int32, compacted by boolean masks to the data's run count."""
    valid = d_s != _I32MAX
    sent = torch.full((1,), -2, dtype=torch.int32, device=d_s.device)
    pd = torch.cat([sent, d_s[:-1]])
    pq = torch.cat([sent, q_s[:-1]])
    nd = torch.cat([d_s[1:], sent])
    nq = torch.cat([q_s[1:], sent])
    is_start = valid & ((d_s != pd) | (q_s != pq + 1))
    is_end = valid & ((d_s != nd) | (q_s != nq - 1))
    return d_s[is_start], q_s[is_start], q_s[is_end]


def expand_block_to_runs(sa_aug: torch.Tensor, lo: torch.Tensor,
                         width: torch.Tensor, start: int, end: int,
                         m_off: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MEM path of one round: expansion, pair sort and run compaction on
    the device; only run boundaries leave it."""
    return _compact_pair_runs(
        *expand_block_pairs(sa_aug, lo, width, start, end, m_off))


# ---------------------------------------------------------------------------
# Run extraction (host side, vectorized numpy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunBatch:
    """Maximal >=K matches as diagonal runs."""

    diag: np.ndarray    # int64 refpos - qpos
    qstart: np.ndarray  # int64 first query position of the run
    qend: np.ndarray    # int64 last  query position of the run (inclusive)


def runs_from_sorted_pairs(d: np.ndarray, q: np.ndarray,
                           m_off: int) -> RunBatch:
    """Decode sorted int32 (diag', qpos) pairs into maximal runs."""
    sel = d != np.iinfo(np.int32).max
    d = d[sel].astype(np.int64) - m_off
    q = q[sel].astype(np.int64)
    if d.size == 0:
        e = np.zeros(0, np.int64)
        return RunBatch(e, e, e.copy())
    brk = np.empty(d.size, dtype=bool)
    brk[0] = True
    brk[1:] = (d[1:] != d[:-1]) | (q[1:] != q[:-1] + 1)
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], d.size)  # exclusive
    diag = d[starts]
    qstart = q[starts]
    qend = qstart + (ends - starts - 1)
    return RunBatch(diag, qstart, qend)


def runs_from_compacted32(run_d: np.ndarray, run_qs: np.ndarray,
                          run_qe: np.ndarray, n_runs: int,
                          m_off: int) -> RunBatch:
    """Decode device-compacted int32 run triples into a RunBatch."""
    return RunBatch((run_d[:n_runs].astype(np.int64) - m_off),
                    run_qs[:n_runs].astype(np.int64),
                    run_qe[:n_runs].astype(np.int64))


def _sort_diag_qstart(diag: np.ndarray, qstart: np.ndarray) -> np.ndarray:
    """Order by (diag, qstart): one stable argsort of a packed int64 key.

    Both columns are biased to non-negative; the shifted key fits int64 at
    any genome scale this engine addresses (diag < 2^35, qstart < 2^28);
    falls back to lexsort if a pathological input ever violates that.
    """
    if diag.size == 0:
        return np.empty(0, np.int64)
    dmin = int(diag.min())          # run diagonals are signed (biased by
    qmin = int(qstart.min())        # -m_off); bias both into [0, span)
    qspan = int(qstart.max()) - min(qmin, 0)
    dspan = int(diag.max()) - min(dmin, 0)
    shift = max(1, qspan.bit_length())
    if qmin < 0 or dspan.bit_length() + shift > 63:
        return np.lexsort((qstart, diag))  # pathological ranges only
    d64 = diag.astype(np.int64)
    if dmin < 0:
        d64 = d64 - np.int64(dmin)
    key = (d64 << np.int64(shift)) | qstart.astype(np.int64)
    return np.argsort(key, kind="stable")


def merge_runs(batches: list[RunBatch]) -> RunBatch:
    """Merge per-round runs whose spans abut across round boundaries.

    Rounds partition query positions into contiguous blocks, so a match
    crossing a block edge appears as two (or more) runs with the same
    diagonal and contiguous [qstart, qend] spans. Chains collapse with a
    groupby over break flags.
    """
    diag = np.concatenate([b.diag for b in batches])
    qstart = np.concatenate([b.qstart for b in batches])
    qend = np.concatenate([b.qend for b in batches])
    if diag.size == 0:
        return RunBatch(diag, qstart, qend)
    order = _sort_diag_qstart(diag, qstart)
    diag, qstart, qend = diag[order], qstart[order], qend[order]
    new = np.empty(diag.size, dtype=bool)
    new[0] = True
    new[1:] = (diag[1:] != diag[:-1]) | (qstart[1:] != qend[:-1] + 1)
    gstart = np.flatnonzero(new)
    gend = np.append(gstart[1:], diag.size) - 1
    return RunBatch(diag[gstart], qstart[gstart], qend[gend])


# ---------------------------------------------------------------------------
# Top-level backend
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SeedMatches:
    """Matches in global text coordinates."""

    refpos: np.ndarray   # int64
    qpos: np.ndarray     # int64
    length: np.ndarray   # int64
    stats: dict | None = None


def _plan_blocks(cum: np.ndarray, m: int, capacity: int,
                 position_block: int) -> list[tuple[int, int]]:
    """Slice [0, m) into blocks whose pair totals fit the round capacity."""
    blocks = []
    start = 0
    while start < m:
        end = int(np.searchsorted(cum, cum[start] + capacity, side="right")) - 1
        end = min(max(end, start + 1), m, start + position_block)
        if cum[end] - cum[start] > capacity:  # single position too wide
            raise NotImplementedError(
                f"query position {start} has interval width "
                f"{int(cum[start + 1] - cum[start])} > pair_capacity "
                f"{capacity}; raise pair_capacity for this input")
        blocks.append((start, end))
        start = end
    return blocks


def query_bucket(m: int) -> int:
    """Padded query length (kept so per-position arrays compare 1:1 with
    the JAX package's, which pads to limit recompiles)."""
    if m <= 1 << 16:
        p = 1 << 10
        while p < m:
            p <<= 1
        return p
    block = 1 << 16
    return -(-m // block) * block


def pad_query(query_text: np.ndarray) -> np.ndarray:
    """Pad with N codes: padded windows are invalid, so zero extra matches."""
    m = int(query_text.shape[0])
    m_p = query_bucket(m)
    if m_p == m:
        return np.asarray(query_text, np.uint8)
    return np.concatenate([np.asarray(query_text, np.uint8),
                           np.full(m_p - m, CODE_N, np.uint8)])


def query_to_device(query_text: np.ndarray, device: torch.device
                    ) -> tuple[np.ndarray, torch.Tensor]:
    """(padded codes, device copy) of a query."""
    qp = pad_query(query_text)
    return qp, torch.from_numpy(qp).to(device)


def pairs_to_matches(index, lo: torch.Tensor, width: torch.Tensor, k: int,
                     m: int, cfg: Config,
                     sa_aug: torch.Tensor | None = None) -> SeedMatches:
    """Shared backend: intervals at depth k -> maximal matches >= min_length.

    Host-side planning slices query positions into rounds whose total pair
    count fits cfg.pair_capacity; each round expands, sorts and compacts on
    the device, and only run triples come back. Works for any
    k <= min_length. Only the single-device ``match_backend="sort"`` path
    at stride 1 is ported.
    """
    if cfg.match_backend != "sort":
        raise NotImplementedError(
            f"match_backend={cfg.match_backend!r} is not ported yet "
            "(ROADMAP A7: boundary backend); use 'sort'")
    if sa_aug is None:
        sa_aug = index.sa  # all rows valid
    capacity = int(cfg.pair_capacity)
    m_s = int(lo.shape[0])
    block = min(cfg.position_block, m_s)
    # qpos can reach m_s - 1 + block; keep d = refpos - qpos + diag_mod/2
    # sortable and collision-free per diagonal
    m_off = (m + block + 2) // 2

    w_host = width.cpu().numpy()
    cum_h = np.concatenate(([0], np.cumsum(w_host, dtype=np.int64)))
    batches = []
    for start, end in _plan_blocks(cum_h, m_s, capacity, block):
        run_d, run_qs, run_qe = expand_block_to_runs(sa_aug, lo, width,
                                                     start, end, m_off)
        batches.append(runs_from_compacted32(
            run_d.cpu().numpy(), run_qs.cpu().numpy(), run_qe.cpu().numpy(),
            int(run_d.shape[0]), m_off))
    return finalize_matches(batches, k, cfg)


def finalize_matches(batches: list[RunBatch], k: int,
                     cfg: Config) -> SeedMatches:
    """Merge per-round run fragments into final matches. MUM/MAM
    uniqueness is decided later from the match set itself
    (apply_mode_filter)."""
    runs = merge_runs(batches) if batches else RunBatch(
        np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64))
    length = runs.qend - runs.qstart + k
    keep = length >= cfg.min_length
    return SeedMatches(
        refpos=(runs.diag + runs.qstart)[keep],
        qpos=runs.qstart[keep],
        length=length[keep],
    )


# ---------------------------------------------------------------------------
# MUM / MAM filtering (SURVEY.md §3.4)
# ---------------------------------------------------------------------------

def _unique_intervals(start: np.ndarray, end: np.ndarray) -> np.ndarray:
    """keep[i] = no OTHER interval [start_j, end_j] contains interval i.

    Sort by (start asc, end desc): any container of i sorts before i and
    its end survives in the exclusive prefix max; exact duplicates contain
    each other, so the earlier twin (which the prefix max misses) is caught
    by the adjacent-duplicate test. O(N log N), fully vectorized.
    """
    n = start.size
    if n == 0:
        return np.zeros(0, bool)
    order = np.lexsort((-end, start))
    s, e = start[order], end[order]
    contained = np.zeros(n, bool)
    contained[1:] = np.maximum.accumulate(e)[:-1] >= e[1:]
    contained[:-1] |= (s[:-1] == s[1:]) & (e[:-1] == e[1:])
    keep = np.empty(n, bool)
    keep[order] = ~contained
    return keep


def apply_mode_filter(matches: SeedMatches, cfg: Config) -> SeedMatches:
    """MEM: identity. MAM: ref-unique. MUM: ref-unique AND query-unique.

    Occurrence uniqueness is decided from the MATCH SET ALONE:

      * ref occurrences of m's string q[m.qpos : m.qpos+m.length] biject
        with maximal matches whose QUERY interval contains m's: an
        occurrence at ref position p extends maximally to a match with
        qstart <= m.qpos, qend >= m.qpos + m.length on diagonal p - m.qpos
        (distinct p -> distinct diagonal -> distinct match), and
        conversely such a match witnesses an occurrence at
        diag + m.qpos. So occ_ref(m) == 1 iff no OTHER match's query
        interval contains m's.
      * query occurrences of the same string biject with maximal matches
        whose REF interval [refpos, refpos+length) contains m's (same
        argument mirrored; distinct query position -> distinct diagonal).

    Every containing match has length >= m.length >= min_length, so the
    min-length-filtered match set contains every candidate container.
    """
    if cfg.mode.value == "mem":
        return matches
    keep = _unique_intervals(matches.qpos, matches.qpos + matches.length)
    if cfg.mode.value == "mum":
        keep &= _unique_intervals(matches.refpos,
                                  matches.refpos + matches.length)
    return SeedMatches(matches.refpos[keep], matches.qpos[keep],
                       matches.length[keep], stats=matches.stats)

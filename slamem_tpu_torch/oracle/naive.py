"""Deliberately simple CPU oracle MEM finder, numpy only (port of
``slamem_tpu/oracle/naive.py``).

It enumerates every maximal exact match by brute-force diagonal run-length
scanning (O(n*m) work, numpy-vectorized per diagonal): slow but obviously
correct, the ground truth the engines are checked against where the JAX
package cannot run.

Match semantics (slaMEM's):
  * only A/C/G/T positions can match; N never matches anything (not even N),
    and inter-sequence separators never match, so no match spans an N run or
    a sequence boundary;
  * a MEM (r, q, len) satisfies ref[r:r+len] == query[q:q+len], len >= L,
    and is extendable in neither direction.
"""

from __future__ import annotations

import numpy as np

from slamem_tpu_torch.io.fasta import CODE_N


def find_mems_codes(ref: np.ndarray, query: np.ndarray, min_len: int,
                    diagonals: range | None = None
                    ) -> list[tuple[int, int, int]]:
    """All MEMs between code arrays ``ref`` and ``query``.

    Returns [(ref_pos, query_pos, length)] with 0-based positions into the
    given arrays (``ref`` may contain separators; positions are global),
    ordered by (query_pos, ref_pos). ``diagonals`` (default: all, -(m-1)
    .. n-1) restricts the scan to those diagonals d = ref_pos - query_pos:
    each diagonal's MEMs depend on it alone, so disjoint ranges split the
    work.
    """
    ref = np.asarray(ref, dtype=np.uint8)
    query = np.asarray(query, dtype=np.uint8)
    n, m = ref.size, query.size
    out: list[tuple[int, int, int]] = []
    if n == 0 or m == 0 or min_len < 1:
        return out
    for d in diagonals if diagonals is not None else range(-(m - 1), n):
        r0, r1 = max(0, d), min(n, m + d)
        if r1 - r0 < min_len:
            continue
        rseg = ref[r0:r1]
        qseg = query[r0 - d:r1 - d]
        eq = (rseg == qseg) & (rseg < CODE_N)
        # maximal runs of True: the edges of the False-padded mask
        # alternate start, end
        edges = np.flatnonzero(np.diff(np.concatenate(([False], eq,
                                                       [False]))))
        starts, ends = edges[0::2], edges[1::2]
        keep = ends - starts >= min_len
        for s, e in zip(starts[keep].tolist(), ends[keep].tolist()):
            out.append((r0 + s, r0 - d + s, e - s))
    out.sort(key=lambda t: (t[1], t[0]))
    return out


def count_occurrences(text: np.ndarray, sub: np.ndarray) -> int:
    """Number of (overlapping) exact occurrences of ``sub`` in ``text``.

    ``sub`` is assumed ACGT-only (MEM strings are); N/separator in ``text``
    match nothing because codes differ. The start positions that match
    ``sub``'s first character are narrowed one character at a time (the
    JAX package compares every window at once; same count).
    """
    text = np.asarray(text, dtype=np.uint8)
    sub = np.asarray(sub, dtype=np.uint8)
    k = sub.size
    if k == 0 or text.size < k:
        return 0
    pos = np.flatnonzero(text[:text.size - k + 1] == sub[0])
    for i in range(1, k):
        if pos.size == 0:
            break
        pos = pos[text[pos + i] == sub[i]]
    return int(pos.size)


def filter_mode(mems: list[tuple[int, int, int]], ref: np.ndarray,
                query: np.ndarray, mode: str) -> list[tuple[int, int, int]]:
    """MUM/MAM uniqueness filters.

    mam: keep MEMs whose matched string occurs exactly once in the reference.
    mum: additionally occurs exactly once in the query.
    """
    if mode == "mem":
        return mems
    ref = np.asarray(ref, dtype=np.uint8)
    out = []
    for r, q, ln in mems:
        sub = ref[r:r + ln]
        if count_occurrences(ref, sub) != 1:
            continue
        if mode == "mum" and count_occurrences(query, sub) != 1:
            continue
        out.append((r, q, ln))
    return out


def oracle_matches(ref: np.ndarray, query: np.ndarray, min_len: int,
                   mode: str = "mem") -> list[tuple[int, int, int]]:
    """find_mems_codes + filter_mode in one call."""
    return filter_mode(find_mems_codes(ref, query, min_len), ref, query, mode)

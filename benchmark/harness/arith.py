"""The benchmark's arithmetic: percentiles, window rates, the union of
device intervals, the device time inside a span, and the index's least
bytes."""

from __future__ import annotations

import bisect
from typing import Callable

# NVIDIA H100 SXM5 80GB HBM3 memory rate, bytes/s (NVIDIA data sheet)
H100_HBM_BYTES_S = 3.35e12


def percentile(values: list[float], p: float) -> float:
    """The p-th percentile, linear between the closest ranks (numpy's
    default): rank p/100 * (n - 1)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = p / 100 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values: list[float]) -> float | None:
    return sum(values) / len(values) if values else None


def rate(work: float, window_s: float) -> float:
    """Work over the window's seconds: all the work, all the time."""
    if window_s <= 0:
        raise ValueError("empty window")
    return work / window_s


def union_length(intervals: list[tuple[int, int]], lo: int, hi: int
                 ) -> tuple[int, list[tuple[int, int]]]:
    """(covered length, idle gaps) of [lo, hi) under the union of
    ``intervals`` (start, end), each clipped to [lo, hi)."""
    covered = 0
    gaps = []
    cursor = lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a or b <= cursor:
            continue
        if a > cursor:
            gaps.append((cursor, a))
            covered += b - a
        else:
            covered += b - cursor
        cursor = b
    if cursor < hi:
        gaps.append((cursor, hi))
    return covered, gaps


def complement(gaps: list[tuple[int, int]], lo: int, hi: int
               ) -> list[tuple[int, int]]:
    """The parts of [lo, hi) outside ``gaps``: sorted, disjoint intervals
    inside it."""
    out, cursor = [], lo
    for a, b in gaps + [(hi, hi)]:
        if a > cursor:
            out.append((cursor, a))
        cursor = b
    return out


def coverage(busy: list[tuple[int, int]]) -> Callable[[int, int], int]:
    """f(a, b): the length of [a, b) that ``busy`` covers (sorted, disjoint
    intervals), by a search and a prefix sum."""
    starts = [s for s, _ in busy]
    before = [0]
    for s, e in busy:
        before.append(before[-1] + e - s)

    def upto(t: int) -> int:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0
        s, e = busy[i]
        return before[i] + min(e, t) - s

    return lambda a, b: upto(b) - upto(a)


def index_bytes(n: int, occ_block: int) -> int:
    """Least bytes an FM-index build of an n-symbol text (terminator
    included) moves: the n - 1 input codes read once; the text (uint8),
    suffix array (int32), BWT (uint8), occ checkpoints (int32, (ceil(n /
    B) + 1) x 4) and C[] (4 x int32) written once."""
    blocks = -(-n // occ_block) + 1
    return (n - 1) + n + 4 * n + n + 16 * blocks + 16

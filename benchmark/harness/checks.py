"""Judging the answers of a window against the reference's listing.

Every answer's size is compared with the expected listing's; the answers
kept by the seed's sample (and the last) are compared line by line. Each
number has the limit 0: the engine is integer-only and its result exact.
"""

from __future__ import annotations

from collections import Counter

LIMITS = {"missing": 0, "extra": 0, "misplaced": 0, "bad_size": 0}


def _lines(listing: str) -> Counter:
    """(entry number, line) of every match line; headers open entries."""
    entry = -1
    out = Counter()
    for line in listing.splitlines():
        if line.startswith(">"):
            entry += 1
        else:
            out[(entry, line)] += 1
    return out


def compare(expected: str, sizes: list[int], kept: dict[int, str]
            ) -> tuple[dict, set[int]]:
    """(numbers, indexes of the answers found wrong).

    missing / extra: the most expected lines absent from, or unexpected
    lines present in, one kept answer; misplaced: the most lines of one
    kept answer that hold the same matches in another order or layout;
    bad_size: answers of the window whose size differs from the expected
    listing's (a failed answer has size -1)."""
    numbers = dict.fromkeys(LIMITS, 0)
    wrong = {i for i, s in enumerate(sizes) if s != len(expected)}
    numbers["bad_size"] = len(wrong)
    want = None
    for i, text in kept.items():
        if text == expected:
            continue
        wrong.add(i)
        want = _lines(expected) if want is None else want
        got = _lines(text)
        miss, extra = want - got, got - want
        numbers["missing"] = max(numbers["missing"], sum(miss.values()))
        numbers["extra"] = max(numbers["extra"], sum(extra.values()))
        if not miss and not extra:
            differ = sum(a != b for a, b in zip(text.splitlines(),
                                                 expected.splitlines()))
            numbers["misplaced"] = max(numbers["misplaced"], max(differ, 1))
    return numbers, wrong


def passed(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)

"""The scan engine's own mechanism in plain torch: the LCP array of a
suffix array, and each query position's SA interval at depth L.

Semantics (the index's order contract): codes 0..3 are bases; a code >= 4
(N, a separator, the text's terminator) is a special, which matches
nothing, itself included, and sorts below every base. Neither function
reads anything of the program: each works from the text, its suffix array
and the query alone, by direct comparison.
"""

from __future__ import annotations

import torch

MATCHABLE = 4          # codes below this are bases
WORD = 8               # characters compared a step of lcp_plain
LCP_BLOCK = 1 << 24    # adjacent pairs at a time
SEARCH_BLOCK = 1 << 20  # query positions searched at a time


def _padded(text: torch.Tensor, extra: int) -> torch.Tensor:
    """The text as int16 codes with ``extra`` specials after its end."""
    tail = torch.full((extra,), MATCHABLE, dtype=torch.int16,
                      device=text.device)
    return torch.cat([text.to(torch.int16), tail])


def lcp_plain(text: torch.Tensor, sa: torch.Tensor,
              block: int = LCP_BLOCK) -> torch.Tensor:
    """(n,) int32: LCP[j] = the common prefix of suffixes sa[j - 1] and
    sa[j], counted up to the first position where they differ or either
    holds a special; LCP[0] = 0.

    Each pair compares WORD characters a step, the pairs still equal on
    all of them going on to the next word, ``block`` pairs at a time.
    """
    n = int(sa.numel())
    dev = sa.device
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    codes = _padded(text, WORD)
    end = int(text.numel())
    off = torch.arange(WORD, dtype=torch.int64, device=dev)
    for s in range(1, n, block):
        e = min(n, s + block)
        a = sa[s - 1:e - 1].to(torch.int64)
        b = sa[s:e].to(torch.int64)
        h = torch.zeros(e - s, dtype=torch.int64, device=dev)
        live = torch.arange(e - s, device=dev)
        while live.numel():
            ha = (a[live] + h[live]).clamp(max=end)[:, None] + off
            hb = (b[live] + h[live]).clamp(max=end)[:, None] + off
            ca, cb = codes[ha], codes[hb]
            same = (ca == cb) & (ca < MATCHABLE)
            run = same.to(torch.int64).cumprod(1).sum(1)
            h[live] += run
            live = live[run == WORD]
        out[s:e] = h.to(torch.int32)
    return out


def _compare(codes: torch.Tensor, starts: torch.Tensor,
             patterns: torch.Tensor) -> torch.Tensor:
    """Per row: -1, 0 or 1 as the first L characters of the suffix at
    ``starts`` order below, equal to or above ``patterns`` (B, L) of
    bases; a special orders below every base."""
    L = patterns.shape[1]
    idx = starts[:, None] + torch.arange(L, device=starts.device)
    s = codes[idx]
    s = torch.where(s < MATCHABLE, s, -1)
    diff = torch.sign(s - patterns)
    nz = diff != 0
    first = nz.to(torch.int8).argmax(1)
    at = diff.gather(1, first[:, None])[:, 0]
    return torch.where(nz.any(1), at, 0)


def _search(codes: torch.Tensor, sa: torch.Tensor, patterns: torch.Tensor,
            upper: bool) -> torch.Tensor:
    """The first SA row whose suffix orders above the pattern (``upper``)
    or not below it, by binary search over the n rows."""
    n = int(sa.numel())
    lo = torch.zeros(patterns.shape[0], dtype=torch.int64,
                     device=sa.device)
    hi = torch.full_like(lo, n)
    while bool((lo < hi).any()):
        go = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        c = _compare(codes, sa[mid.clamp(max=n - 1)].to(torch.int64),
                     patterns)
        right = (c <= 0) if upper else (c < 0)
        lo = torch.where(go & right, mid + 1, lo)
        hi = torch.where(go & ~right, mid, hi)
    return lo


def intervals_plain(text: torch.Tensor, sa: torch.Tensor,
                    query: torch.Tensor, L: int,
                    block: int = SEARCH_BLOCK
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, width) int32 per query position i: the SA rows [lo, lo +
    width) whose suffixes begin with q[i:i + L], found by two binary
    searches over the SA; width 0 where q[i:i + L] holds a special, runs
    past the query's end or occurs nowhere (lo is then 0). ``block``
    positions at a time."""
    m = int(query.numel())
    dev = sa.device
    codes = _padded(text, L)
    q = query.to(device=dev, dtype=torch.int16)
    lo_out = torch.zeros(m, dtype=torch.int32, device=dev)
    w_out = torch.zeros(m, dtype=torch.int32, device=dev)
    starts = torch.arange(m - L + 1, device=dev) if m >= L else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    off = torch.arange(L, device=dev)
    for s in range(0, starts.numel(), block):
        pos = starts[s:s + block]
        pat = q[pos[:, None] + off]
        ok = (pat < MATCHABLE).all(1)
        pos, pat = pos[ok], pat[ok]
        lo = _search(codes, sa, pat, upper=False)
        hi = _search(codes, sa, pat, upper=True)
        hit = hi > lo
        lo_out[pos[hit]] = lo[hit].to(torch.int32)
        w_out[pos[hit]] = (hi - lo)[hit].to(torch.int32)
    return lo_out, w_out

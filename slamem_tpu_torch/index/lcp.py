"""LCP array construction (port of ``slamem_tpu/index/lcp.py``).

Re-run the prefix-doubling rounds keeping every rank array (rank_t tells
2^t-char prefixes apart, about 4 B x n per round), then resolve
lcp(sa[j-1], sa[j]) for all adjacent pairs at once by binary descent:
h += 2^t wherever rank_t[a+h] == rank_t[b+h]. Each level is one
gather+compare over all pairs — no sequential Kasai scan.

Rank equality at level t implies both suffixes have >= 2^t characters left
and they agree on all of them (truncated suffixes get -1 components and
specials carry unique ranks, so equality never crosses an N, a separator or
the text end) — which is exactly the lcp semantics the engines need.
"""

from __future__ import annotations

import torch

from slamem_tpu_torch.index.build import doubling_ranks


def _rank_rounds(text: torch.Tensor) -> list[torch.Tensor]:
    """All doubling rank arrays: rounds[t] distinguishes 2^t-char prefixes."""
    return list(doubling_ranks(text))


def _descend(a: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
             rt: torch.Tensor, step: int) -> torch.Tensor:
    n = rt.shape[0]
    ia = (a + h).clamp(max=n - 1)
    ib = (b + h).clamp(max=n - 1)
    eq = (rt[ia] == rt[ib]) & (a + h < n) & (b + h < n)
    return torch.where(eq, h + step, h)


def lcp_adjacent(text: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """LCP[j] = lcp(suffix sa[j-1], suffix sa[j]); LCP[0] = 0. int32 (n,)."""
    n = int(sa.shape[0])
    if n <= 1:
        return torch.zeros(n, dtype=torch.int32, device=sa.device)
    rounds = _rank_rounds(text)
    a = sa[:-1].to(torch.int64)
    b = sa[1:].to(torch.int64)
    h = torch.zeros(n - 1, dtype=torch.int64, device=sa.device)
    for t in reversed(range(len(rounds))):
        h = _descend(a, b, h, rounds[t], 1 << t)
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=sa.device),
                      h.to(torch.int32)])

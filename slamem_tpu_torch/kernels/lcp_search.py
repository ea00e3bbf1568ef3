"""Batched, branchless LCP-interval queries (port of
``slamem_tpu/kernels/lcp_search.py``, which is XLA, not Pallas).

PSV/NSV (previous/next smaller value) over the full LCP array through an
F-ary block-minimum pyramid: every query is a fixed number of 128-wide
masked gather+reduce steps, with no data-dependent branching.

Queries served:
  * psv(j, v): largest i <= j with LCP[i] <  v   (left edge of an expansion)
  * nsv(j, v): smallest i >= j with LCP[i] < v   (right edge)
  * expand(l, r, v): the SA range of the enclosing interval at depth >= v —
    i.e. I(*, v) from any deeper interval [l, r): one psv + one nsv;
  * parent depth of [l, r): max(LCP[l], LCP[r]).

Sentinels: position 0 and position n carry LCP -1, so every query resolves
without bounds logic (depth-0 expansion returns the full range [0, n)).
"""

from __future__ import annotations

import dataclasses

import torch

F = 128  # pyramid fan-out: one 128-wide gather+reduce per level

_I32MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class LcpPyramid:
    """LCP array + block minima; all engines share one instance per index."""

    levels: tuple[torch.Tensor, ...]  # levels[0] = LCP_ext (n+1,), then minima
    n: int                            # number of SA rows

    @classmethod
    def build(cls, lcp: torch.Tensor) -> "LcpPyramid":
        """lcp: (n,) int32 with lcp[0] arbitrary (overwritten by sentinel)."""
        n = int(lcp.shape[0])
        neg = torch.full((1,), -1, dtype=torch.int32, device=lcp.device)
        ext = torch.cat([neg, lcp[1:].to(torch.int32), neg])  # (n+1,)
        levels = [ext]
        cur = ext
        while cur.shape[0] > F:
            pad = (-cur.shape[0]) % F
            padded = torch.cat([cur, torch.full((pad,), _I32MAX,
                                                dtype=torch.int32,
                                                device=lcp.device)])
            cur = padded.view(-1, F).amin(1)
            levels.append(cur)
        return cls(levels=tuple(levels), n=n)


def _lane_idx(device: torch.device) -> torch.Tensor:
    return torch.arange(F, dtype=torch.int32, device=device)[None, :]


def _last_below(vals: torch.Tensor, upto: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    """Per lane: largest idx <= upto with vals[lane, idx] < v, else -1."""
    idx = _lane_idx(vals.device)
    hit = (vals < v[:, None]) & (idx <= upto[:, None])
    return torch.where(hit, idx, -1).amax(1)


def _first_below(vals: torch.Tensor, frm: torch.Tensor, v: torch.Tensor
                 ) -> torch.Tensor:
    """Per lane: smallest idx >= frm with vals[lane, idx] < v, else F."""
    idx = _lane_idx(vals.device)
    hit = (vals < v[:, None]) & (idx >= frm[:, None])
    return torch.where(hit, idx, F).amin(1)


def _gather_block(level: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """(B, F) values of level block ``block``; out-of-range slots read
    int32 max. Blocks left of 0 or past the end only occur in lanes whose
    answer is already found, so their values are never used."""
    base = (block.to(torch.int64)[:, None] * F
            + torch.arange(F, dtype=torch.int64, device=block.device)[None, :])
    size = level.shape[0]
    vals = level[base.clamp(0, size - 1)]
    return torch.where((base >= 0) & (base < size), vals, _I32MAX)


def psv(pyr: LcpPyramid, j: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched previous-smaller-value; j int32 (B,), v int32 (B,).

    Always resolves (sentinel at 0). Ascends the pyramid until the partial
    block left of j contains a value < v, then descends to the exact index.
    """
    j = j.to(torch.int32)
    v = v.to(torch.int32)
    nlev = len(pyr.levels)
    pos = j
    found = torch.full_like(j, -1)     # level at which a hit exists
    hit_idx = torch.zeros_like(j)      # index within that level
    for t in range(nlev):
        blk = torch.div(pos, F, rounding_mode="floor")
        off = pos - blk * F
        cand = _last_below(_gather_block(pyr.levels[t], blk), off, v)
        ok = (cand >= 0) & (found < 0)
        found = torch.where(ok, t, found)
        hit_idx = torch.where(ok, blk * F + cand, hit_idx)
        pos = blk - 1  # next level examines strictly-left blocks
    # Descend: a hit at level t names a block at level t-1, and so on.
    res = hit_idx
    last = torch.full_like(res, F - 1)
    for t in range(nlev - 1, 0, -1):
        active = found >= t
        cand = _last_below(_gather_block(pyr.levels[t - 1], res), last, v)
        res = torch.where(active, res * F + cand, res)
    return res


def nsv(pyr: LcpPyramid, j: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched next-smaller-value (sentinel at n resolves every query)."""
    j = j.to(torch.int32)
    v = v.to(torch.int32)
    nlev = len(pyr.levels)
    pos = j
    found = torch.full_like(j, -1)
    hit_idx = torch.zeros_like(j)
    for t in range(nlev):
        blk = torch.div(pos, F, rounding_mode="floor")
        off = pos - blk * F
        cand = _first_below(_gather_block(pyr.levels[t], blk), off, v)
        ok = (cand < F) & (found < 0)
        found = torch.where(ok, t, found)
        hit_idx = torch.where(ok, blk * F + cand, hit_idx)
        pos = blk + 1
    res = hit_idx
    first = torch.zeros_like(res)
    for t in range(nlev - 1, 0, -1):
        active = found >= t
        cand = _first_below(_gather_block(pyr.levels[t - 1], res), first, v)
        res = torch.where(active, res * F + cand, res)
    return res


def expand(pyr: LcpPyramid, l: torch.Tensor, r: torch.Tensor,
           v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Enclosing SA range at depth >= v of intervals [l, r) (batched).

    Rows [l', r') share a prefix of length >= v with each other; v <= 0
    returns the full range. Requires the true interval depth >= v.
    """
    return psv(pyr, l, v), nsv(pyr, r, v)


def parent_depth(pyr: LcpPyramid, l: torch.Tensor, r: torch.Tensor
                 ) -> torch.Tensor:
    """Depth of the parent lcp-interval of [l, r): max(LCP[l], LCP[r]).

    Clamped at 0 (the root interval); sentinel -1 entries make boundary
    handling automatic.
    """
    ext = pyr.levels[0]
    ln = l.to(torch.int64).clamp(0, pyr.n)
    rn = r.to(torch.int64).clamp(0, pyr.n)
    return torch.maximum(torch.maximum(ext[ln], ext[rn]),
                         torch.zeros((), dtype=torch.int32, device=ext.device))

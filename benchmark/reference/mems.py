"""Every maximal exact match between a reference and one query sequence,
in plain torch: the benchmark's yardstick of the program's listings.

Semantics (slaMEM's): only A/C/G/T (codes 0..3) match; any code >= 4 (N,
a separator) matches nothing, itself included. A MEM (r, q, len) has
ref[r:r+len] == qry[q:q+len], len >= L, and extends in neither direction.

Method: the K-mer at every query position that is a multiple of S =
L - K + 1 is looked up among all reference K-mers (one sort, two binary
searches), and each hit is extended both ways base by base. A MEM of
length >= L spans len - K + 1 >= S window starts, so one of them is
sampled: the set is complete, and extension makes each hit maximal.
``find_mems(..., stride=S + 1)`` is the control: it breaks that
guarantee and misses the MEMs whose window starts all fall between
samples.
"""

from __future__ import annotations

import torch

MATCHABLE = 4          # codes below this are bases
HIT_BLOCK = 1 << 21    # hits extended at a time
EXTEND_STEP = 32       # bases compared a step of the extension


def seed_plan(min_len: int) -> tuple[int, int]:
    """(K, S): K about half of L (at most 31, so a key fits an int64) and
    the largest stride that stays complete."""
    k = min(31, (min_len + 1) // 2)
    return k, min_len - k + 1


def window_keys(codes: torch.Tensor, k: int, starts: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys, valid) of the K-mers at ``starts`` (every start if None):
    2 bits a base, the first base highest; valid = no code >= 4 in it."""
    if starts is None:
        w = codes.numel() - k + 1
        key = torch.zeros(max(w, 0), dtype=torch.int64, device=codes.device)
        bad = torch.zeros(max(w, 0), dtype=torch.bool, device=codes.device)
        for j in range(k):
            c = codes[j:j + w]
            bad |= c >= MATCHABLE
            key.mul_(4).add_((c & 3).to(torch.int64))
        return key, ~bad
    win = codes[starts[:, None] + torch.arange(k, device=codes.device)]
    key = torch.zeros(starts.numel(), dtype=torch.int64, device=codes.device)
    for j in range(k):
        key.mul_(4).add_((win[:, j] & 3).to(torch.int64))
    return key, ~(win >= MATCHABLE).any(1)


def run_length(ref: torch.Tensor, qry: torch.Tensor, r0: torch.Tensor,
               q0: torch.Tensor, step: int) -> torch.Tensor:
    """How many bases match from (r0, q0) on, going by ``step`` (+1 right,
    -1 left), before a mismatch, a code >= 4 or an end of either text."""
    n, m = ref.numel(), qry.numel()
    total = torch.zeros_like(r0)
    active = torch.arange(r0.numel(), device=r0.device)
    lane = torch.arange(EXTEND_STEP, device=r0.device)
    off = 0
    while active.numel():
        rp = r0[active, None] + step * (off + lane)
        qp = q0[active, None] + step * (off + lane)
        inside = (rp >= 0) & (rp < n) & (qp >= 0) & (qp < m)
        rc = ref[rp.clamp(0, max(n - 1, 0))]
        qc = qry[qp.clamp(0, max(m - 1, 0))]
        same = inside & (rc == qc) & (rc < MATCHABLE)
        run = same.to(torch.int32).cumprod(1).sum(1)
        total[active] += run
        active = active[run == EXTEND_STEP]
        off += EXTEND_STEP
    return total


class ReferenceTable:
    """The sorted K-mers of one reference text, built once for every query
    entry of a run."""

    def __init__(self, ref: torch.Tensor, min_len: int):
        self.ref = ref
        self.min_len = min_len
        self.k, self.stride = seed_plan(min_len)
        key, valid = window_keys(ref, self.k, None)
        pos = valid.nonzero().squeeze(1)
        self.keys, order = torch.sort(key[pos])
        self.pos = pos[order]
        del key, valid, order

    def find_mems(self, qry: torch.Tensor, stride: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(ref_pos, q_pos, length) of every MEM of length >= L, ordered
        by (q_pos, ref_pos). ``stride`` other than the plan's is the
        control."""
        k, ref, n = self.k, self.ref, self.ref.numel()
        dev = ref.device
        stride = stride or self.stride
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        if qry.numel() < k or self.keys.numel() == 0:
            return empty, empty, empty
        qs = torch.arange(0, qry.numel() - k + 1, stride, device=dev)
        qkey, ok = window_keys(qry, k, qs)
        qkey, qs = qkey[ok], qs[ok]
        lo = torch.searchsorted(self.keys, qkey)
        cnt = torch.searchsorted(self.keys, qkey, right=True) - lo
        hit = cnt.nonzero().squeeze(1)
        lo, cnt, qs = lo[hit], cnt[hit], qs[hit]
        # split the sampled windows into blocks of about HIT_BLOCK hits
        ends = torch.cumsum(cnt, 0)
        total = int(ends[-1]) if ends.numel() else 0
        cuts = torch.searchsorted(ends, torch.arange(
            HIT_BLOCK, max(total, HIT_BLOCK), HIT_BLOCK, device=dev),
            right=True).tolist()
        found = []
        for a, b in zip([0] + cuts, cuts + [cnt.numel()]):
            if a == b:
                continue
            c = cnt[a:b]
            which = torch.repeat_interleave(torch.arange(b - a, device=dev), c)
            first = torch.cumsum(c, 0) - c
            r = self.pos[lo[a:b][which] + torch.arange(which.numel(),
                                                       device=dev)
                         - first[which]]
            q = qs[a:b][which]
            left = run_length(ref, qry, r - 1, q - 1, -1)
            right = run_length(ref, qry, r + k, q + k, 1)
            length = left + k + right
            keep = length >= self.min_len
            found.append(((q - left)[keep], (r - left)[keep], length[keep]))
        if not found:
            return empty, empty, empty
        q, r, length = (torch.cat(x) for x in zip(*found))
        # a MEM is one (q, r) start; order by q, then r
        uniq, inv = torch.unique(q * (n + 1) + r, return_inverse=True)
        out_len = torch.zeros_like(uniq).scatter_(0, inv, length)
        return uniq % (n + 1), uniq // (n + 1), out_len

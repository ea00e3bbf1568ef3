"""FM-index construction in PyTorch (port of ``slamem_tpu/index/build.py``).

Suffix array by Manber–Myers prefix doubling: O(log n) rounds, each one
``torch.sort`` of packed (rank, rank@+k) int64 keys; BWT is one gather and
the occ checkpoints one reshape + cumsum. The full suffix array stays on the
device (int32, 4n bytes): a direct gather replaces a sampled-SA locate walk.

Alphabet / sort-order contract (shared with the engines and io/fasta.py):
codes A=0 C=1 G=2 T=3, N=4, SEP=5. Every N/SEP position receives a UNIQUE
sort rank strictly below all A ranks (rank = its own position index), so no
two suffixes ever compare equal across an N or a sequence boundary — this is
what enforces "matches never span N / boundaries" at the index level.
Suffix order is therefore: (specials, by position) < A < C < G < T, and a
shorter suffix that prefixes a longer one sorts first. Under this contract
the suffix array is unique, so SA, BWT, occ checkpoints and C[] equal the
JAX package's bit for bit (tests/test_torch_index.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from slamem_tpu_torch.io.fasta import CODE_N, CODE_SEP
from slamem_tpu_torch.utils.device import resolve_device

BWT_SENTINEL = 6  # bwt "char" for the row whose suffix starts at position 0


@dataclasses.dataclass(frozen=True)
class FMIndex:
    """Immutable FM-index over a (separator-joined) reference text."""

    text: torch.Tensor      # (n,) uint8 codes 0..5, CODE_SEP terminated
    sa: torch.Tensor        # (n,) int32 suffix array
    bwt: torch.Tensor       # (n,) uint8: text[sa-1], BWT_SENTINEL at sa==0
    occ_ckpt: torch.Tensor  # (n_blocks+1, 4) int32: per-char counts in bwt[:b*B]
    counts: torch.Tensor    # (4,) int32: C[c] = #suffixes starting with sym < c
    occ_block: int          # checkpoint spacing B
    # tables derived from the index (LCP pyramid, interleaved rank rows),
    # built once on first use by the engines that need them
    derived: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def n(self) -> int:
        return int(self.text.shape[0])

    @property
    def device(self) -> torch.device:
        return self.text.device


def initial_ranks(text: torch.Tensor) -> torch.Tensor:
    """Round-0 suffix ranks: unique-per-position for specials, below ACGT."""
    n = text.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=text.device)
    return torch.where(text >= CODE_N, pos, n + text.to(torch.int32))


def _round_body(rank: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One prefix-doubling round: ranks by 2k chars from ranks by k chars.

    rank@+k is a shift with -1 past the end (a suffix shorter than k sorts
    smallest). The two int32 keys pack into one int64 as (rank+1, rank@k+1),
    both in [0, 2^31), so one ``torch.sort`` orders them lexicographically;
    ties need no stable order because equal keys get equal new ranks. The
    new ranks go back to position order by a scatter through the sort
    permutation. Returns (new_rank, max_rank) with max_rank on the device.
    """
    n = rank.shape[0]
    rank_k = torch.full_like(rank, -1)
    if k < n:
        rank_k[:n - k] = rank[k:]
    key = ((rank.to(torch.int64) + 1) << 32) | (rank_k.to(torch.int64) + 1)
    key_s, order = torch.sort(key)
    is_new = torch.zeros(n, dtype=torch.int32, device=rank.device)
    is_new[1:] = (key_s[1:] != key_s[:-1]).to(torch.int32)
    new_rank_sorted = torch.cumsum(is_new, 0, dtype=torch.int32)
    new_rank = torch.empty_like(rank)
    new_rank[order] = new_rank_sorted
    return new_rank, new_rank_sorted[-1]


def doubling_ranks(text: torch.Tensor) -> Iterator[torch.Tensor]:
    """Round-0 ranks, then every doubling round's ranks (rank_t tells
    2^t-char prefixes apart), until the ranks are all distinct or k >= n.

    One scalar device->host read per round decides the early exit.
    """
    n = int(text.shape[0])
    rank = initial_ranks(text)
    yield rank
    k = 1
    while True:
        rank, max_rank = _round_body(rank, k)
        yield rank
        if int(max_rank) == n - 1 or k >= n:
            return
        k *= 2


def suffix_array(text: torch.Tensor) -> torch.Tensor:
    """Suffix array by prefix doubling (int32)."""
    n = int(text.shape[0])
    if n <= 1:
        return torch.zeros(n, dtype=torch.int32, device=text.device)
    for rank in doubling_ranks(text):
        pass
    return torch.argsort(rank).to(torch.int32)


def _finish_index(text: torch.Tensor, sa: torch.Tensor, occ_block: int):
    """BWT, occ checkpoints and C[] from (text, sa)."""
    n = text.shape[0]
    dev = text.device
    sa64 = sa.to(torch.int64)
    prev = torch.where(sa64 == 0, 0, sa64 - 1)
    bwt = torch.where(sa64 == 0,
                      torch.tensor(BWT_SENTINEL, dtype=torch.uint8,
                                   device=dev),
                      text[prev])

    n_blocks = -(-n // occ_block)
    pad = n_blocks * occ_block - n
    # sentinel-pad so padding never counts toward any ACGT char
    bwt_p = torch.cat([bwt, torch.full((pad,), BWT_SENTINEL, dtype=torch.uint8,
                                       device=dev)]).view(n_blocks, occ_block)
    per_block = torch.stack([(bwt_p == c).sum(1, dtype=torch.int32)
                             for c in range(4)], dim=1)
    occ_ckpt = torch.cat([torch.zeros((1, 4), dtype=torch.int32, device=dev),
                          torch.cumsum(per_block, 0, dtype=torch.int32)])

    char_counts = torch.stack([(text == c).sum(dtype=torch.int32)
                               for c in range(4)])
    n_special = n - char_counts.sum(dtype=torch.int32)
    counts = n_special + torch.cat(
        [torch.zeros(1, dtype=torch.int32, device=dev),
         torch.cumsum(char_counts, 0, dtype=torch.int32)[:3]])
    return bwt, occ_ckpt, counts.to(torch.int32)


def build_index(text: np.ndarray | torch.Tensor, occ_block: int = 128,
                device: str | torch.device = "cuda") -> FMIndex:
    """Build the full FM-index on ``device`` from a code array.

    A trailing CODE_SEP terminator is appended internally (FMIndex.text and
    FMIndex.n include it): without it, suffixes that run off the text end are
    reachable by no LF step and backward search undercounts matches touching
    the last position. The terminator is a special with the largest position
    index, so it sorts after all other specials and below every base.
    """
    dev = resolve_device(device)
    if not isinstance(text, torch.Tensor):
        text = torch.from_numpy(np.ascontiguousarray(text, dtype=np.uint8))
    body = text.to(device=dev, dtype=torch.uint8)
    text_t = torch.cat([body, torch.full((1,), CODE_SEP, dtype=torch.uint8,
                                         device=dev)])
    sa = suffix_array(text_t)
    bwt, occ_ckpt, counts = _finish_index(text_t, sa, occ_block)
    return FMIndex(text=text_t, sa=sa, bwt=bwt, occ_ckpt=occ_ckpt,
                   counts=counts, occ_block=occ_block)


def rank_batch(index: FMIndex, chars: torch.Tensor, positions: torch.Tensor
               ) -> torch.Tensor:
    """occ(c, j): count of char c in bwt[0:j), batched (plain reference).

    One checkpoint row + one B-symbol block per query. The interleaved-table
    kernel in kernels/rank.py is held against this.
    """
    B = index.occ_block
    p = positions.to(torch.int64)
    c = chars.to(torch.int64)
    block = torch.div(p, B, rounding_mode="floor")
    within = p - block * B
    base = index.occ_ckpt[block, c]
    lane = torch.arange(B, dtype=torch.int64, device=p.device)[None, :]
    rows = index.bwt[(block[:, None] * B + lane).clamp(max=index.n - 1)]
    in_block = ((rows == c[:, None].to(torch.uint8)) &
                (lane < within[:, None])).sum(1, dtype=torch.int32)
    return base + in_block

"""FM-index construction in PyTorch (port of ``slamem_tpu/index/build.py``).

Suffix array by one stable ``torch.sort`` of every suffix's first 27
characters as a base-5 int64 (``sa_keys``: one kernel on the card), then
Manber–Myers prefix doubling from 27 characters only where those prefixes
repeat, each round one ``torch.sort`` of packed (rank, rank@+k) int64 keys;
the sort whose ranks come out distinct gives the suffix array. BWT is one
gather and the occ checkpoints one kernel on the card (``occ_checkpoints``).
The full suffix array stays on the device (int32, 4n bytes): a direct
gather replaces a sampled-SA locate walk.

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

import numpy as np
import torch

from slamem_tpu_torch.io.fasta import CODE_N, CODE_SEP
from slamem_tpu_torch.kernels.occ import load_kernel as load_occ
from slamem_tpu_torch.kernels.sakeys import load_kernel as load_sa_keys
from slamem_tpu_torch.utils.device import resolve_device
from slamem_tpu_torch.utils.pack2 import codes_to_device

BWT_SENTINEL = 6  # bwt "char" for the row whose suffix starts at position 0
PACKED_UPLOAD_MIN = 1 << 20  # numpy texts from this length ride the wire
SA_KEY_CHARS = 27            # characters a window key holds: 5^27 < 2^63


@dataclasses.dataclass(frozen=True)
class FMIndex:
    """Immutable FM-index over a (separator-joined) reference text."""

    text: torch.Tensor      # (n,) uint8 codes 0..5, CODE_SEP terminated
    sa: torch.Tensor        # (n,) int32 suffix array
    bwt: torch.Tensor       # (n,) uint8: text[sa-1], BWT_SENTINEL at sa==0
    occ_ckpt: torch.Tensor  # (n_blocks+1, 4) int32: per-char counts in bwt[:b*B]
    counts: torch.Tensor    # (4,) int32: C[c] = #suffixes starting with sym < c
    occ_block: int          # checkpoint spacing B
    # tables derived from the index (LCP pyramid, interleaved rank rows,
    # seed / bucket / extension tables), built once on first use by the
    # engines that need them
    derived: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def n(self) -> int:
        return int(self.text.shape[0])

    @property
    def device(self) -> torch.device:
        return self.text.device


def _dense_ranks(is_new: torch.Tensor) -> torch.Tensor:
    """Ranks of n sorted rows from ``is_new`` (n - 1 bools: row j + 1
    starts a new rank): 0 at the first row, one more at each new rank."""
    new = torch.zeros(is_new.shape[0] + 1, dtype=torch.int32,
                      device=is_new.device)
    new[1:] = is_new
    return torch.cumsum(new, 0, dtype=torch.int32)


def _round_sort(rank: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sort of one prefix-doubling round: (order, new ranks in sorted
    order) by 2k chars from ranks by k chars.

    rank@+k is a shift with -1 past the end (a suffix shorter than k sorts
    smallest). The two int32 keys pack into one int64 as (rank+1, rank@k+1),
    both in [0, 2^31), so one ``torch.sort`` orders them lexicographically;
    ties need no stable order because equal keys get equal new ranks.
    """
    n = rank.shape[0]
    rank_k = torch.full_like(rank, -1)
    if k < n:
        rank_k[:n - k] = rank[k:]
    key = ((rank.to(torch.int64) + 1) << 32) | (rank_k.to(torch.int64) + 1)
    del rank_k
    key_s, order = torch.sort(key)
    del key
    return order, _dense_ranks(key_s[1:] != key_s[:-1])


def sa_keys_plain(text: torch.Tensor) -> torch.Tensor:
    """sa_keys by torch ops: SA_KEY_CHARS passes, each a multiply-add of
    one character's digit over every position."""
    n = text.shape[0]
    codes = torch.cat([text, torch.full((SA_KEY_CHARS - 1,), CODE_N,
                                        dtype=torch.uint8,
                                        device=text.device)])
    key = torch.zeros(n, dtype=torch.int64, device=text.device)
    live = torch.ones(n, dtype=torch.bool, device=text.device)
    for j in range(SA_KEY_CHARS):
        c = codes[j:j + n]
        live &= c < CODE_N
        key = key * 5 + torch.where(live, c.to(torch.int64) + 1, 0)
    return key


def sa_keys(text: torch.Tensor) -> torch.Tensor:
    """(n,) int64 window keys of a uint8 code text: key[i] holds the first
    SA_KEY_CHARS characters of suffix i in base 5, the first character
    most significant; A, C, G, T are the digits 1..4, and N, SEP and a
    position past the text are 0, as is every digit from the first of
    them on. So the keys order as the suffixes' first SA_KEY_CHARS
    characters under the order contract, equal specials aside, and a key
    holds a special exactly when ``key % 5 == 0``.

    CUDA tensors launch ``slamem_sa_keys`` of ``kernels/csrc/sakeys.cu``
    on the current stream (16 positions a thread from aligned 16-byte
    loads at the text's real address, stores staged through shared
    memory), without synchronising, and count the call in
    ``sa_keys.launches``; an empty text launches nothing. CPU tensors take
    sa_keys_plain.
    """
    if text.dtype != torch.uint8 or text.dim() != 1 or \
            not text.is_contiguous():
        raise ValueError(f"text must be a 1-D contiguous uint8 tensor, got "
                         f"{tuple(text.shape)} {text.dtype}")
    if text.device.type == "cpu":
        return sa_keys_plain(text)
    n = text.numel()
    keys = torch.empty(n, dtype=torch.int64, device=text.device)
    if n == 0:
        return keys
    with torch.cuda.device(text.device):
        stream = torch.cuda.current_stream(text.device).cuda_stream
        err = load_sa_keys().fn(text.data_ptr(), n, keys.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"window key kernel launch failed: CUDA error "
                           f"{err}")
    sa_keys.launches += 1
    return keys


sa_keys.launches = 0


def suffix_array(text: torch.Tensor) -> torch.Tensor:
    """Suffix array (int32) of a text that ends in its CODE_SEP terminator.

    One stable sort of the window keys (``sa_keys``) ranks the suffixes by
    their first SA_KEY_CHARS characters: a row is a new rank where its key
    differs from the row before or holds a special. Equal keys that hold a
    special are the same prefix with a special at the same offset, which
    the contract orders by position, as the stable sort leaves them. While
    the ranks repeat, one scatter puts them back in position order and a
    doubling round from k = SA_KEY_CHARS sorts again (k doubling). The
    sort whose ranks come out distinct gives the suffix array as its
    permutation: no scatter and no argsort after it. One scalar read a
    sort; each sort counts in ``suffix_array.sorts``.
    """
    n = int(text.shape[0])
    if n <= 1:
        return torch.zeros(n, dtype=torch.int32, device=text.device)
    key_s, order = torch.sort(sa_keys(text), stable=True)
    suffix_array.sorts += 1
    rank_s = _dense_ranks((key_s[1:] != key_s[:-1]) | (key_s[1:] % 5 == 0))
    del key_s
    k = SA_KEY_CHARS
    while int(rank_s[-1]) != n - 1:
        rank = torch.empty(n, dtype=torch.int32, device=text.device)
        rank[order] = rank_s
        del order, rank_s
        order, rank_s = _round_sort(rank, k)
        suffix_array.sorts += 1
        del rank
        k *= 2
    return order.to(torch.int32)


suffix_array.sorts = 0


def occ_checkpoints_plain(bwt: torch.Tensor, occ_block: int
                          ) -> torch.Tensor:
    """occ_checkpoints by torch ops: the BWT sentinel-padded to whole
    blocks, four compare-and-sum passes and a cumsum over the blocks."""
    n = bwt.shape[0]
    dev = bwt.device
    n_blocks = -(-n // occ_block)
    pad = n_blocks * occ_block - n
    # sentinel-pad so padding never counts toward any ACGT char
    bwt_p = torch.cat([bwt, torch.full((pad,), BWT_SENTINEL, dtype=torch.uint8,
                                       device=dev)]).view(n_blocks, occ_block)
    per_block = torch.stack([(bwt_p == c).sum(1, dtype=torch.int32)
                             for c in range(4)], dim=1)
    return torch.cat([torch.zeros((1, 4), dtype=torch.int32, device=dev),
                      torch.cumsum(per_block, 0, dtype=torch.int32)])


def occ_checkpoints(bwt: torch.Tensor, occ_block: int) -> torch.Tensor:
    """(ceil(n / occ_block) + 1, 4) int32 occ checkpoints of a uint8 BWT:
    row r counts A, C, G, T in bwt[:r * occ_block] (the last row in all of
    it); N, SEP and the sentinel count for nothing.

    CUDA tensors launch ``slamem_occ_checkpoints`` of ``kernels/csrc/
    occ.cu`` on the current stream (count the tiles, scan their totals,
    write the rows: 16 bytes a thread where occ_block % 16 == 0, a byte
    loop otherwise), without synchronising, and count the call in
    ``occ_checkpoints.launches``. CPU tensors take occ_checkpoints_plain.
    """
    if not 1 <= occ_block < 1 << 31:
        raise ValueError(f"occ_block must lie in [1, 2^31), got {occ_block}")
    if bwt.dtype != torch.uint8 or bwt.dim() != 1 or not bwt.is_contiguous():
        raise ValueError(f"bwt must be a 1-D contiguous uint8 tensor, got "
                         f"{tuple(bwt.shape)} {bwt.dtype}")
    n = bwt.numel()
    if n >= 1 << 31:
        raise ValueError(f"occ counts are int32: {n} symbols is too many")
    if bwt.device.type == "cpu":
        return occ_checkpoints_plain(bwt, occ_block)
    kernel = load_occ()
    occ = torch.empty((-(-n // occ_block) + 1, 4), dtype=torch.int32,
                      device=bwt.device)
    sums = torch.empty((kernel.tiles(n), 4), dtype=torch.int32,
                       device=bwt.device)
    with torch.cuda.device(bwt.device):
        stream = torch.cuda.current_stream(bwt.device).cuda_stream
        err = kernel.fn(bwt.data_ptr(), n, occ_block, sums.data_ptr(),
                        occ.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"occ checkpoint kernel launch failed: CUDA error "
                           f"{err}")
    occ_checkpoints.launches += 1
    return occ


occ_checkpoints.launches = 0


def _finish_index(text: torch.Tensor, sa: torch.Tensor, occ_block: int):
    """BWT, occ checkpoints and C[] from (text, sa), the text ending in its
    CODE_SEP terminator.

    The BWT holds every symbol of the text but the terminator, and the
    sentinel, so its ACGT totals (the last checkpoint row) are the text's.
    """
    n = text.shape[0]
    dev = text.device
    sa64 = sa.to(torch.int64)
    prev = torch.where(sa64 == 0, 0, sa64 - 1)
    bwt = torch.where(sa64 == 0,
                      torch.tensor(BWT_SENTINEL, dtype=torch.uint8,
                                   device=dev),
                      text[prev])
    occ_ckpt = occ_checkpoints(bwt, occ_block)
    char_counts = occ_ckpt[-1]
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

    A numpy text of >= 2^20 codes rides the 2-bit packed wire
    (utils/pack2.py), its plane padded to a multiple of 4 codes; a torch
    tensor, a shorter text or a special-dense one (> 1/8 N or SEP) takes
    the plain upload, as in the JAX package.
    """
    dev = resolve_device(device)
    body = None
    if isinstance(text, np.ndarray) and text.size >= PACKED_UPLOAD_MIN:
        n = int(text.size)
        plane = np.asarray(text, np.uint8)
        if n % 4:
            plane = np.concatenate([plane, np.zeros(4 - n % 4, np.uint8)])
        unpacked = codes_to_device(plane, n, dev)
        if unpacked is not None:
            body = unpacked[:n]
    if body is None:
        if not isinstance(text, torch.Tensor):
            text = torch.from_numpy(np.ascontiguousarray(text,
                                                         dtype=np.uint8))
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


def backward_step(index: FMIndex, c: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One batched FM backward-extension step: the interval of c+pattern.

    (lo, hi) are SA-interval bounds [lo, hi); c integer codes in 0..3. One
    rank_batch of the concatenated bounds, plus C[c], as in the JAX
    package.
    """
    occ = rank_batch(index, torch.cat([c, c]), torch.cat([lo, hi]))
    k = lo.shape[0]
    cbase = index.counts[c.to(torch.int64)]
    return cbase + occ[:k], cbase + occ[k:]

"""Batched FM-index rank/occ queries over one-row-per-query tables, and the
scan engine's backward search built on them.

occ(c, j) = count of char c in bwt[0:j). Two table layouts of the JAX
package's ``slamem_tpu/kernels/rank.py``, bit for bit:

    interleaved, 128 int32 words per row (rank_rows, kernel K0):
        row b = [ occ_A, occ_C, occ_G, occ_T at position b*496 |
                  124 words x 4 bytes = 496 BWT symbols, little-endian ]
    nibble, W int32 words per row (rank_rows_nib; W = row_words > 4, 128
    by default, the scan engine's table):
        row b = [ occ_A..occ_T at position b*P | W - 4 words x 8 nibbles =
                  P = 8 (W - 4) symbols, nibble i at bits 4i ]

so one query touches exactly one row. ``rank_rows`` and ``rank_rows_nib``
launch the hand-written CUDA kernels of ``csrc/rank.cu`` on CUDA tensors
(K0 ports the Pallas kernel ``slamem_tpu/kernels/rank.py::_rank_kernel``;
the nibble kernels port the XLA function ``rank_rows_nib`` of the same
file: one for 128-word rows, one for any other width) and their plain
PyTorch versions ``rank_rows_plain`` / ``rank_rows_nib_plain`` on CPU
tensors; neither falls back from one to the other. ``rank_pallas``,
``rank_nib`` and ``rank_xla`` are the JAX package's index-level drop-ins
for ``index.build.rank_batch``. ``scan_lanes`` launches the scan kernel
(one warp per scan lane,
the whole capped backward search of ``engine/scan_mode.py::_scan_lanes``
with the same row counts inside, each occ pair counted from the nearer of
two row counters) on either layout. The library
is compiled by ``nvcc`` for sm_90a at first use, from the source in this
package, into ``kernels/build/`` (git-ignored), and loaded with ctypes
through plain C entry points. Nothing is built or imported for it when
this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from slamem_tpu_torch.kernels import build_nvcc

ROW_WORDS = 128     # int32 words per interleaved row (512 B)
CNT_WORDS = 4       # leading occ counter words
SYMS_PER_ROW = (ROW_WORDS - CNT_WORDS) * 4  # 496 BWT symbols per row
NIB_PER_ROW = (ROW_WORDS - CNT_WORDS) * 8   # 992 per nibble-table row
ROW_BYTES = ROW_WORDS * 4

_SOURCE = Path(__file__).parent / "csrc" / "rank.cu"


def _build_rows(bwt: torch.Tensor) -> torch.Tensor:
    """Interleaved (rows, 128) int32 occ/BWT table from a uint8 BWT."""
    n = bwt.shape[0]
    nrows = n // SYMS_PER_ROW + 1  # +1: position j == n stays in range
    pad = nrows * SYMS_PER_ROW - n
    # sentinel-pad (6): padding never counts toward any ACGT char
    sym = torch.cat([bwt, torch.full((pad,), 6, dtype=torch.uint8,
                                     device=bwt.device)]).view(nrows,
                                                               SYMS_PER_ROW)
    per_row = torch.stack([(sym == c).sum(1, dtype=torch.int32)
                           for c in range(4)], dim=1)
    prefix = torch.cumsum(per_row, 0, dtype=torch.int32) - per_row
    return torch.cat([prefix, sym.view(torch.int32)], dim=1).contiguous()


def interleaved_rows(index) -> torch.Tensor:
    """The interleaved occ/BWT table of an FMIndex, built once per index."""
    rows = index.derived.get("rank_rows")
    if rows is None:
        rows = index.derived["rank_rows"] = _build_rows(index.bwt)
    return rows


def rank_rows_plain(rows: torch.Tensor, chars: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """occ(c, j) over the interleaved table in plain PyTorch: one row
    gather, then a byte compare under a position mask (the semantics of the
    JAX package's rank_rows_xla). The reference the kernel is held to."""
    p = positions.to(torch.int64)
    c = chars.to(torch.int64)
    blk = torch.div(p, SYMS_PER_ROW, rounding_mode="floor")
    within = p - blk * SYMS_PER_ROW
    base = rows[blk, c]
    sym = rows.view(torch.uint8)[blk, CNT_WORDS * 4:]      # (batch, 496)
    lane = torch.arange(SYMS_PER_ROW, device=rows.device)[None, :]
    hits = ((sym == c[:, None].to(torch.uint8)) & (lane < within[:, None])
            ).sum(1, dtype=torch.int32)
    return base + hits


def _nib_per_row(row_words: int) -> int:
    """Symbols of a nibble-table row of ``row_words`` words; raises unless
    4 < row_words and the count fits int32."""
    if not CNT_WORDS < row_words <= CNT_WORDS + (2**31 - 1) // 8:
        raise ValueError(f"row_words must lie in ({CNT_WORDS}, "
                         f"{CNT_WORDS + (2**31 - 1) // 8}], got {row_words}")
    return (row_words - CNT_WORDS) * 8


def _build_rows_nib(bwt: torch.Tensor,
                    row_words: int = ROW_WORDS) -> torch.Tensor:
    """Nibble-packed (rows, row_words) int32 occ/BWT table from a uint8
    BWT.

    The JAX package's ``_build_rows_nib`` at the same width, bit for bit:
    its uint32 words all lie below 2^31 (the top nibble is at most 6, the
    counters count fewer than 2^31 symbols), so the int32 bits equal them.
    Symbols 0..6 (ACGT, N, SEP, the BWT sentinel and the pad 6) fit a
    nibble; pad 6 never counts toward an ACGT char. Counters by per-row
    counts + cumsum.
    """
    nib_per = _nib_per_row(row_words)
    n = bwt.shape[0]
    nrows = n // nib_per + 1  # +1: position j == n stays in range
    pad = nrows * nib_per - n
    sym = torch.cat([bwt, torch.full((pad,), 6, dtype=torch.uint8,
                                     device=bwt.device)]).view(nrows, nib_per)
    per_row = torch.stack([(sym == c).sum(1, dtype=torch.int32)
                           for c in range(4)], dim=1)
    prefix = torch.cumsum(per_row, 0, dtype=torch.int32) - per_row
    nib = sym.view(nrows, row_words - CNT_WORDS, 8)
    words = torch.zeros((nrows, row_words - CNT_WORDS), dtype=torch.int32,
                        device=bwt.device)
    for i in range(8):          # nibble i of a word at bits 4i..4i+3
        words |= nib[:, :, i].to(torch.int32) << (4 * i)
    return torch.cat([prefix, words], dim=1).contiguous()


def nibble_rows(index, row_words: int = ROW_WORDS) -> torch.Tensor:
    """The nibble occ/BWT table of an FMIndex at ``row_words`` words a row,
    built once per index and width."""
    key = "rank_rows_nib" if row_words == ROW_WORDS else \
        f"rank_rows_nib_{row_words}"
    rows = index.derived.get(key)
    if rows is None:
        rows = index.derived[key] = _build_rows_nib(index.bwt, row_words)
    return rows


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of 32-bit values held in int64 (SWAR; torch has no
    population count). Every intermediate stays below 2^57."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


# elements of one (queries, symbol words) block of the plain nibble count:
# a wide table's batch goes through in blocks of queries, not at once
_PLAIN_BLOCK = 1 << 27


def rank_rows_nib_plain(rows: torch.Tensor, chars: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """occ(c, j) over a nibble table of any width (``rows.shape[1]``) in
    plain PyTorch: one row gather, then the JAX package's rank_rows_nib
    SWAR count, in blocks of at most 2^27 (query, word) elements. The
    reference the kernels are held to.

    With y = word ^ (c * 0x11111111) and t = y & 0x77777777, the high bit
    of nibble i of ~((t + 0x77777777) | y) is set iff that nibble of y is
    zero, i.e. symbol i equals c (adding 7 to a 3-bit value never carries
    out of its nibble). Words below within // 8 count whole, the boundary
    word under the mask (1 << 4*(within % 8)) - 1 (0 when within % 8 == 0),
    later words not at all. 32-bit arithmetic in int64 (torch has no
    uint32 arithmetic; t + 0x77777777 overflows int32), masked to 32 bits.
    """
    nwords = rows.shape[1] - CNT_WORDS
    nib_per = _nib_per_row(rows.shape[1])
    step = max(1, _PLAIN_BLOCK // nwords)
    return torch.cat([_nib_count(rows, chars[a:a + step],
                                 positions[a:a + step], nwords, nib_per)
                      for a in range(0, positions.numel(), step)]
                     or [positions.new_empty(0, dtype=torch.int32)])


def _nib_count(rows: torch.Tensor, chars: torch.Tensor,
               positions: torch.Tensor, nwords: int,
               nib_per: int) -> torch.Tensor:
    p = positions.to(torch.int64)
    c = chars.to(torch.int64)
    blk = torch.div(p, nib_per, rounding_mode="floor")
    within = p - blk * nib_per
    row = rows[blk]                                       # (batch, width)
    base = row.gather(1, c[:, None])[:, 0]
    w = row[:, CNT_WORDS:].to(torch.int64) & 0xFFFFFFFF   # (batch, nwords)
    y = w ^ (c * 0x11111111)[:, None]
    t = y & 0x77777777
    nz = ~((t + 0x77777777) | y) & 0x88888888
    widx = torch.arange(nwords, device=rows.device)[None, :]
    wf = (within // 8)[:, None]
    pmask = ((1 << (4 * (within % 8))) - 1)[:, None]
    mask = torch.where(widx < wf, 0xFFFFFFFF,
                       torch.where(widx == wf, pmask, 0))
    cnt = popcount32(nz & mask).sum(1)
    return (base.to(torch.int64) + cnt).to(torch.int32)


MAX_LEVELS = 8     # pyramid levels the scan kernel takes by value


class _Pyramid(ctypes.Structure):
    """``Pyramid`` of ``csrc/rank.cu``: level pointers and sizes."""
    _fields_ = [("level", ctypes.c_void_p * MAX_LEVELS),
                ("size", ctypes.c_int64 * MAX_LEVELS),
                ("nlev", ctypes.c_int32)]


class _Kernel(NamedTuple):
    fn: ctypes._CFuncPtr       # slamem_rank_rows (K0)
    nib_fn: ctypes._CFuncPtr   # slamem_rank_rows_nib (128-word rows)
    nib_any_fn: ctypes._CFuncPtr  # slamem_rank_rows_nib_any (any width)
    scan_fns: dict             # layout -> slamem_scan_lanes_k0 / _nib
    blocks_per_sm: ctypes._CFuncPtr  # slamem_scan_lanes_blocks_per_sm
    path: Path
    build_log: str


@functools.cache
def load_kernel() -> _Kernel:
    """Build (once per source and flags) and load the rank kernel library
    (every entry point of ``csrc/rank.cu``)."""
    path, log = build_nvcc(_SOURCE, "rank")
    lib = ctypes.CDLL(str(path))
    # (rows, chars, positions, out, nq, nrows[, row_words], stream)
    fn = lib.slamem_rank_rows
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int32,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nib_fn = lib.slamem_rank_rows_nib
    nib_fn.argtypes = fn.argtypes
    nib_fn.restype = ctypes.c_int
    nib_any_fn = lib.slamem_rank_rows_nib_any
    nib_any_fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    nib_any_fn.restype = ctypes.c_int
    scan_fns = {}
    for layout in SCAN_LAYOUTS:
        f = getattr(lib, f"slamem_scan_lanes_{layout}")
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                      ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p]
        f.restype = ctypes.c_int
        scan_fns[layout] = f
    blocks_per_sm = lib.slamem_scan_lanes_blocks_per_sm
    blocks_per_sm.argtypes = [ctypes.c_int]
    blocks_per_sm.restype = ctypes.c_int
    return _Kernel(fn, nib_fn, nib_any_fn, scan_fns, blocks_per_sm, path,
                   log)


def _check(rows: torch.Tensor, chars: torch.Tensor, positions: torch.Tensor,
           layout: str) -> None:
    """Argument check of both wrappers: rows (nrows >= 1, width) int32 with
    width 128 ("k0") or any width > 4 ("nib"), 16-byte aligned at 128
    words; positions inside the table's span of nrows * symbols a row."""
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[0] < 1 or \
            (layout == "k0" and rows.shape[1] != ROW_WORDS):
        width = ROW_WORDS if layout == "k0" else "row_words"
        raise ValueError(f"rows must be (nrows >= 1, {width}) int32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    syms_per_row = SYMS_PER_ROW if layout == "k0" else \
        _nib_per_row(rows.shape[1])
    for name, t in (("chars", chars), ("positions", positions)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on {rows.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if chars.shape != positions.shape:
        raise ValueError(f"chars {tuple(chars.shape)} and positions "
                         f"{tuple(positions.shape)} differ in shape")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if rows.shape[1] == ROW_WORDS and rows.data_ptr() % 16:
        raise ValueError("128-word rows must be 16-byte aligned")
    if positions.numel():
        pmin, pmax, cmin, cmax = torch.stack(
            [positions.min(), positions.max(), chars.min(), chars.max()]
        ).tolist()
        span = rows.shape[0] * syms_per_row
        if pmin < 0 or pmax >= span:
            raise ValueError(f"positions must lie in [0, {span}), got "
                             f"[{pmin}, {pmax}]")
        if cmin < 0 or cmax > 3:
            raise ValueError(f"chars must lie in [0, 3], got [{cmin}, {cmax}]")


def _launch(fn, rows: torch.Tensor, chars: torch.Tensor,
            positions: torch.Tensor, *width) -> torch.Tensor:
    """Launch one entry point on the current stream of the rows' card
    (the table's row count for the last-row rule; ``width``: the row
    width, for the any-width entry)."""
    out = torch.empty_like(positions)
    nq = positions.numel()
    if nq == 0:
        return out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), chars.data_ptr(), positions.data_ptr(),
                 out.data_ptr(), nq, rows.shape[0], *width, stream)
    if err != 0:
        raise RuntimeError(f"rank kernel launch failed: CUDA error {err}")
    return out


def rank_rows(rows: torch.Tensor, chars: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """occ(c, j) batched over a prebuilt interleaved table, int32 (batch,).

    ``positions`` must lie in [0, nrows*496): every j <= n does, and a j
    past n reads only sentinel padding, so it answers occ(c, n). CUDA
    tensors launch the kernel on the current stream, without synchronising,
    and count the launch in ``rank_rows.launches``; CPU tensors take
    ``rank_rows_plain``.
    """
    _check(rows, chars, positions, "k0")
    if rows.device.type == "cpu":
        return rank_rows_plain(rows, chars, positions)
    out = _launch(load_kernel().fn, rows, chars, positions)
    if positions.numel():
        rank_rows.launches += 1
    return out


rank_rows.launches = 0


def rank_rows_nib(rows: torch.Tensor, chars: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """occ(c, j) batched over a prebuilt nibble table of any width
    (``rows.shape[1]`` words), int32 (batch,).

    ``positions`` must lie in [0, nrows * 8 * (width - 4)). CUDA tensors
    launch a kernel on the current stream, without synchronising: at 128
    words the 128-word kernel (launches in ``rank_rows_nib.launches``), at
    any other width the any-width kernel (``rank_rows_nib.any_launches``).
    CPU tensors take ``rank_rows_nib_plain``.
    """
    _check(rows, chars, positions, "nib")
    if rows.device.type == "cpu":
        return rank_rows_nib_plain(rows, chars, positions)
    kernel = load_kernel()
    if rows.shape[1] == ROW_WORDS:
        out = _launch(kernel.nib_fn, rows, chars, positions)
        if positions.numel():
            rank_rows_nib.launches += 1
    else:
        out = _launch(kernel.nib_any_fn, rows, chars, positions,
                      rows.shape[1])
        if positions.numel():
            rank_rows_nib.any_launches += 1
    return out


rank_rows_nib.launches = 0
rank_rows_nib.any_launches = 0


def _queries(chars: torch.Tensor, positions: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(chars, positions) of an index-level call as the wrappers take
    them: 1-D contiguous int32, as ``rank_batch`` takes any integer type."""
    return (chars.to(torch.int32).contiguous(),
            positions.to(torch.int32).contiguous())


def rank_pallas(index, chars: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
    """occ(c, j) batched over the index's interleaved table: K0 on a card
    (the JAX package's Pallas path), drop-in for rank_batch. The JAX
    ``interpret`` flag has no counterpart: an index on the CPU takes the
    plain version."""
    return rank_rows(interleaved_rows(index), *_queries(chars, positions))


def rank_nib(index, chars: torch.Tensor, positions: torch.Tensor,
             row_words: int = ROW_WORDS) -> torch.Tensor:
    """occ(c, j) batched over the index's nibble table of ``row_words``
    words a row (the FM block-size knob), drop-in for rank_batch."""
    return rank_rows_nib(nibble_rows(index, row_words),
                         *_queries(chars, positions))


def rank_xla(index, chars: torch.Tensor, positions: torch.Tensor
             ) -> torch.Tensor:
    """occ(c, j) batched by the plain row gather over the index's
    interleaved table on its device (the JAX package's non-Pallas path;
    no kernel), drop-in for rank_batch."""
    c, p = _queries(chars, positions)
    rows = interleaved_rows(index)
    _check(rows, c, p, "k0")
    return rank_rows_plain(rows, c, p)

# scan kernel layouts: symbols per table row
SCAN_LAYOUTS = {"k0": SYMS_PER_ROW, "nib": NIB_PER_ROW}


def _scan_args(rows: torch.Tensor, layout: str, counts: torch.Tensor, pyr,
               qt: torch.Tensor, L: int, lane_block: int) -> None:
    """Argument check of ``scan_lanes``, from shapes, dtypes and pointers
    alone (no read of the data): the table and pyramid are an index's of
    n = pyr.n SA rows, so every position the kernel forms lies in
    [0, n]."""
    if layout not in SCAN_LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(SCAN_LAYOUTS)}, "
                         f"got {layout!r}")
    n = pyr.n
    if rows.dtype != torch.int32 or rows.dim() != 2 or \
            rows.shape != (n // SCAN_LAYOUTS[layout] + 1, ROW_WORDS):
        raise ValueError(f"rows must be the ({n // SCAN_LAYOUTS[layout] + 1},"
                         f" {ROW_WORDS}) int32 {layout} table of an index of "
                         f"{n} rows, got {tuple(rows.shape)} {rows.dtype}")
    if counts.dtype != torch.int32 or counts.shape != (4,):
        raise ValueError(f"counts must be (4,) int32, got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    if qt.dtype != torch.uint8 or qt.dim() != 1:
        raise ValueError(f"qt must be 1-D uint8, got {tuple(qt.shape)} "
                         f"{qt.dtype}")
    levels = pyr.levels
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"the scan kernel takes 1..{MAX_LEVELS} pyramid "
                         f"levels, got {len(levels)}")
    if levels[0].shape != (n + 1,) or n + 1 >= 2**31:
        raise ValueError(f"pyramid level 0 must hold n + 1 = {n + 1} values,"
                         f" got {tuple(levels[0].shape)}")
    for name, t in (("counts", counts), ("qt", qt),
                    *((f"level {k}", lv) for k, lv in enumerate(levels))):
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on "
                             f"{rows.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for k, lv in enumerate(levels):
        if lv.dtype != torch.int32 or lv.dim() != 1 or lv.data_ptr() % 16:
            raise ValueError(f"pyramid level {k} must be 1-D int32, 16-byte "
                             "aligned")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("rows must be contiguous and 16-byte aligned")
    if L < 1 or lane_block < 1 or L + lane_block >= 2**31:
        raise ValueError(f"need L >= 1, lane_block >= 1, L + lane_block < "
                         f"2^31; got {L}, {lane_block}")


def scan_lanes(rows: torch.Tensor, layout: str, counts: torch.Tensor, pyr,
               qt: torch.Tensor, L: int, lane_block: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Capped backward-search scan of query codes ``qt``: (lo, width) int32
    per position, width r - l of the SA interval of q[i:i+L] (0 where it is
    absent), as ``engine/scan_mode.py::_scan_lanes``.

    ``rows`` is the index's ``layout`` table ("k0": interleaved, "nib":
    nibble), ``counts`` its C[0..3], ``pyr`` its ``LcpPyramid``. CUDA
    tensors launch one scan kernel on the current stream (one warp per lane
    of ``lane_block`` positions), without synchronising, and count the
    launch in ``scan_lanes.launches[layout]``; CPU tensors take the plain
    lockstep loop over the layout's plain occ.
    """
    _scan_args(rows, layout, counts, pyr, qt, L, lane_block)
    if rows.device.type == "cpu":
        from slamem_tpu_torch.engine.scan_mode import scan_lanes_plain
        return scan_lanes_plain(rows, layout, counts, pyr, qt, L, lane_block)
    m = qt.numel()
    out_lo = torch.empty(m, dtype=torch.int32, device=rows.device)
    out_w = torch.empty_like(out_lo)
    if m == 0:
        return out_lo, out_w
    arg = _Pyramid()
    arg.nlev = len(pyr.levels)
    for k, lv in enumerate(pyr.levels):
        arg.level[k] = lv.data_ptr()
        arg.size[k] = lv.numel()
    fn = load_kernel().scan_fns[layout]
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), counts.data_ptr(), ctypes.addressof(arg),
                 qt.data_ptr(), m, pyr.n, L, lane_block, out_lo.data_ptr(),
                 out_w.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"scan kernel launch failed: CUDA error {err}")
    scan_lanes.launches[layout] += 1
    return out_lo, out_w


scan_lanes.launches = dict.fromkeys(SCAN_LAYOUTS, 0)

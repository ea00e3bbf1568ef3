"""Batched FM-index rank/occ queries over one-row-per-query tables.

occ(c, j) = count of char c in bwt[0:j). Two table layouts of the JAX
package's ``slamem_tpu/kernels/rank.py``, bit for bit:

    interleaved, 128 int32 words per row (rank_rows, kernel K0):
        row b = [ occ_A, occ_C, occ_G, occ_T at position b*496 |
                  124 words x 4 bytes = 496 BWT symbols, little-endian ]
    nibble, 128 int32 words per row (rank_rows_nib):
        row b = [ occ_A..occ_T at position b*992 |
                  124 words x 8 nibbles = 992 symbols, nibble i at bits 4i ]

so one query touches exactly one row. ``rank_rows`` and ``rank_rows_nib``
launch the hand-written CUDA kernels of ``csrc/rank.cu`` on CUDA tensors
(K0 ports the Pallas kernel ``slamem_tpu/kernels/rank.py::_rank_kernel``;
the nibble kernel ports the XLA function ``rank_rows_nib`` of the same
file) and their plain PyTorch versions ``rank_rows_plain`` /
``rank_rows_nib_plain`` on CPU tensors; neither falls back from one to the
other. The library is compiled by ``nvcc`` for sm_90a at first use, from
the source in this package, into ``kernels/build/`` (git-ignored), and
loaded with ctypes through plain C entry points. Nothing is built or
imported for it when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path
from typing import NamedTuple

import torch

from slamem_tpu_torch._native import build_shared, find_tool

ROW_WORDS = 128     # int32 words per interleaved row (512 B)
CNT_WORDS = 4       # leading occ counter words
SYMS_PER_ROW = (ROW_WORDS - CNT_WORDS) * 4  # 496 BWT symbols per row
NIB_PER_ROW = (ROW_WORDS - CNT_WORDS) * 8   # 992 per nibble-table row
ROW_BYTES = ROW_WORDS * 4

_SOURCE = Path(__file__).parent / "csrc" / "rank.cu"
_BUILD_DIR = Path(__file__).parent / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def _build_rows_nib(bwt: torch.Tensor) -> torch.Tensor:
    """Nibble-packed (rows, 128) int32 occ/BWT table from a uint8 BWT.

    The JAX package's ``_build_rows_nib`` at its default 128 words, bit for
    bit: its uint32 words all lie below 2^31 (the top nibble is at most 6,
    the counters count fewer than 2^31 symbols), so the int32 bits equal
    them. Symbols 0..6 (ACGT, N, SEP, the BWT sentinel and the pad 6) fit a
    nibble; pad 6 never counts toward an ACGT char. Counters by per-row
    counts + cumsum.
    """
    n = bwt.shape[0]
    nrows = n // NIB_PER_ROW + 1  # +1: position j == n stays in range
    pad = nrows * NIB_PER_ROW - n
    sym = torch.cat([bwt, torch.full((pad,), 6, dtype=torch.uint8,
                                     device=bwt.device)]).view(nrows,
                                                               NIB_PER_ROW)
    per_row = torch.stack([(sym == c).sum(1, dtype=torch.int32)
                           for c in range(4)], dim=1)
    prefix = torch.cumsum(per_row, 0, dtype=torch.int32) - per_row
    nib = sym.view(nrows, ROW_WORDS - CNT_WORDS, 8)
    words = torch.zeros((nrows, ROW_WORDS - CNT_WORDS), dtype=torch.int32,
                        device=bwt.device)
    for i in range(8):          # nibble i of a word at bits 4i..4i+3
        words |= nib[:, :, i].to(torch.int32) << (4 * i)
    return torch.cat([prefix, words], dim=1).contiguous()


def nibble_rows(index) -> torch.Tensor:
    """The nibble occ/BWT table of an FMIndex, built once per index."""
    rows = index.derived.get("rank_rows_nib")
    if rows is None:
        rows = index.derived["rank_rows_nib"] = _build_rows_nib(index.bwt)
    return rows


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of 32-bit values held in int64 (SWAR; torch has no
    population count). Every intermediate stays below 2^57."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def rank_rows_nib_plain(rows: torch.Tensor, chars: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """occ(c, j) over the nibble table in plain PyTorch: one row gather,
    then the JAX package's rank_rows_nib SWAR count. The reference the
    kernel is held to.

    With y = word ^ (c * 0x11111111) and t = y & 0x77777777, the high bit
    of nibble i of ~((t + 0x77777777) | y) is set iff that nibble of y is
    zero, i.e. symbol i equals c (adding 7 to a 3-bit value never carries
    out of its nibble). Words below within // 8 count whole, the boundary
    word under the mask (1 << 4*(within % 8)) - 1 (0 when within % 8 == 0),
    later words not at all. 32-bit arithmetic in int64 (torch has no
    uint32 arithmetic; t + 0x77777777 overflows int32), masked to 32 bits.
    """
    nwords = ROW_WORDS - CNT_WORDS
    p = positions.to(torch.int64)
    c = chars.to(torch.int64)
    blk = torch.div(p, NIB_PER_ROW, rounding_mode="floor")
    within = p - blk * NIB_PER_ROW
    row = rows[blk]                                       # (batch, 128)
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


class _Kernel(NamedTuple):
    fn: ctypes._CFuncPtr       # slamem_rank_rows (K0)
    nib_fn: ctypes._CFuncPtr   # slamem_rank_rows_nib
    path: Path
    build_log: str


@functools.cache
def load_kernel() -> _Kernel:
    """Build (once per source and flags) and load the rank kernel library
    (both entry points of ``csrc/rank.cu``)."""
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    nvcc = find_tool("nvcc", cuda_home / "bin" / "nvcc")
    path, log = build_shared(nvcc, _NVCC_FLAGS, _SOURCE, _BUILD_DIR, "rank")
    lib = ctypes.CDLL(str(path))
    fn = lib.slamem_rank_rows
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nib_fn = lib.slamem_rank_rows_nib
    nib_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    nib_fn.restype = ctypes.c_int
    return _Kernel(fn, nib_fn, path, log)


def _check(rows: torch.Tensor, chars: torch.Tensor, positions: torch.Tensor,
           syms_per_row: int) -> None:
    """Argument check of both wrappers: rows (nrows >= 1, 128) int32,
    positions inside the table's span of nrows * syms_per_row."""
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[0] < 1 or \
            rows.shape[1] != ROW_WORDS:
        raise ValueError(f"rows must be (nrows >= 1, {ROW_WORDS}) int32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
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
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("rows must be contiguous and 16-byte aligned")
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
            positions: torch.Tensor) -> torch.Tensor:
    """Launch one entry point on the current stream of the rows' card."""
    out = torch.empty_like(positions)
    nq = positions.numel()
    if nq == 0:
        return out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), chars.data_ptr(), positions.data_ptr(),
                 out.data_ptr(), nq, stream)
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
    _check(rows, chars, positions, SYMS_PER_ROW)
    if rows.device.type == "cpu":
        return rank_rows_plain(rows, chars, positions)
    out = _launch(load_kernel().fn, rows, chars, positions)
    if positions.numel():
        rank_rows.launches += 1
    return out


rank_rows.launches = 0


def rank_rows_nib(rows: torch.Tensor, chars: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """occ(c, j) batched over a prebuilt nibble table, int32 (batch,).

    ``positions`` must lie in [0, nrows*992). CUDA tensors launch the
    kernel on the current stream, without synchronising, and count the
    launch in ``rank_rows_nib.launches``; CPU tensors take
    ``rank_rows_nib_plain``.
    """
    _check(rows, chars, positions, NIB_PER_ROW)
    if rows.device.type == "cpu":
        return rank_rows_nib_plain(rows, chars, positions)
    out = _launch(load_kernel().nib_fn, rows, chars, positions)
    if positions.numel():
        rank_rows_nib.launches += 1
    return out


rank_rows_nib.launches = 0

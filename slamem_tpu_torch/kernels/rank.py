"""Batched FM-index rank/occ queries over the interleaved table.

occ(c, j) = count of char c in bwt[0:j). The BWT is re-blocked into an
INTERLEAVED table of 128-int32 rows (the layout of the JAX package's
``slamem_tpu/kernels/rank.py``, bit for bit):

    row b = [ occ_A, occ_C, occ_G, occ_T at position b*496 |
              124 words x 4 bytes = 496 BWT symbols, little-endian ]

so one query touches exactly one 512-byte row. ``rank_rows`` launches the
hand-written CUDA kernel ``csrc/rank.cu`` (the port of the Pallas kernel
``slamem_tpu/kernels/rank.py::_rank_kernel``) on CUDA tensors and the plain
PyTorch version ``rank_rows_plain`` on CPU tensors; it never falls back from
one to the other. The kernel is compiled by ``nvcc`` for sm_90a at first use,
from the source in this package, into ``kernels/build/`` (git-ignored); it is
loaded with ctypes through a plain C entry point. Nothing is built or
imported for it when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

ROW_WORDS = 128     # int32 words per interleaved row (512 B)
CNT_WORDS = 4       # leading occ counter words
SYMS_PER_ROW = (ROW_WORDS - CNT_WORDS) * 4  # 496 BWT symbols per row
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


class _Kernel(NamedTuple):
    fn: ctypes._CFuncPtr
    path: Path
    build_log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the rank "
                       "kernel is built from source at first use")


@functools.cache
def load_kernel() -> _Kernel:
    """Build (once per source and flags) and load the rank kernel library.

    The build writes a temporary file and renames it into place, so
    concurrent first uses never load a half-written library.
    """
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    path = _BUILD_DIR / f"librank_{digest}.so"
    log = ""
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp,
                                   str(_SOURCE)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            log = proc.stdout + proc.stderr
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    fn = ctypes.CDLL(str(path)).slamem_rank_rows
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _Kernel(fn, path, log)


def _check(rows: torch.Tensor, chars: torch.Tensor,
           positions: torch.Tensor) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 2 or \
            rows.shape[1] != ROW_WORDS or rows.shape[0] < 1:
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
        span = rows.shape[0] * SYMS_PER_ROW
        if pmin < 0 or pmax >= span:
            raise ValueError(f"positions must lie in [0, {span}), got "
                             f"[{pmin}, {pmax}]")
        if cmin < 0 or cmax > 3:
            raise ValueError(f"chars must lie in [0, 3], got [{cmin}, {cmax}]")


def rank_rows(rows: torch.Tensor, chars: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """occ(c, j) batched over a prebuilt interleaved table, int32 (batch,).

    ``positions`` must lie in [0, nrows*496): every j <= n does, and a j
    past n reads only sentinel padding, so it answers occ(c, n). CUDA
    tensors launch the kernel on the current stream, without synchronising,
    and count the launch in ``rank_rows.launches``; CPU tensors take
    ``rank_rows_plain``.
    """
    _check(rows, chars, positions)
    if rows.device.type == "cpu":
        return rank_rows_plain(rows, chars, positions)
    kernel = load_kernel()
    out = torch.empty_like(positions)
    nq = positions.numel()
    if nq == 0:
        return out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = kernel.fn(rows.data_ptr(), chars.data_ptr(),
                        positions.data_ptr(), out.data_ptr(), nq, stream)
    if err != 0:
        raise RuntimeError(f"rank kernel launch failed: CUDA error {err}")
    rank_rows.launches += 1
    return out


rank_rows.launches = 0

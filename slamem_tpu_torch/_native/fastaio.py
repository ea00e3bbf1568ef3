"""ctypes binding of the port's native FASTA parser (``fastaio.c``).

The library is built by gcc at first use (``build_gcc``); a failed build
raises. The numpy parser ``io/fasta.py::parse_fasta_bytes`` has the same
contract and is what the tests hold this one to.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from slamem_tpu_torch._native import build_gcc

_SOURCE = Path(__file__).parent / "fastaio.c"
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_LONGP = ctypes.POINTER(ctypes.c_long)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_gcc(_SOURCE, "fastaio")))
    lib.fasta_parse.restype = ctypes.c_long
    lib.fasta_parse.argtypes = [ctypes.c_char_p, ctypes.c_long, _U8P,
                                ctypes.POINTER(_LONGP), _LONGP]
    lib.fasta_free.restype = None
    lib.fasta_free.argtypes = [_LONGP]
    return lib


def parse(buf: bytes, source: str = "<bytes>", stats: dict | None = None):
    """Parse FASTA bytes -> FastaSet (the contract of parse_fasta_bytes).

    One pass of the C parser. ``codes`` is a view, not a copy, of the
    ``len(buf) + 16``-byte array the pass wrote: the bytes past the codes
    (a file's newlines and headers) stay unused. ``stats``, if given,
    gets ``wide_bp``: the codes written by the 16-byte steps (the rest by
    the scalar loop, on lines with whitespace inside)."""
    from slamem_tpu_torch.io.fasta import FastaSet

    if len(buf) == 0:
        raise ValueError(f"{source}: empty FASTA input")
    lib = _lib()
    codes = np.empty(len(buf) + 16, dtype=np.uint8)
    recs = _LONGP()
    counts = np.zeros(2, dtype=np.int64)
    nseq = lib.fasta_parse(buf, len(buf), codes.ctypes.data_as(_U8P),
                           ctypes.byref(recs), counts.ctypes.data_as(_LONGP))
    if nseq == -1:
        raise ValueError(f"{source}: not FASTA (no leading '>' header)")
    if nseq < 0:
        raise MemoryError(f"{source}: no memory for the FASTA record table")
    try:
        table = np.ctypeslib.as_array(recs, shape=(nseq, 3)).copy()
    finally:
        lib.fasta_free(recs)
    bp, wide_bp = counts.tolist()
    if stats is not None:
        stats["wide_bp"] = wide_bp
    names = [buf[off:off + ln].decode("ascii", "replace")
             for off, ln in table[:, 1:].tolist()]
    starts = table[:, 0].copy()
    return FastaSet(names=names, starts=starts,
                    lengths=np.diff(starts, append=bp), codes=codes[:bp])

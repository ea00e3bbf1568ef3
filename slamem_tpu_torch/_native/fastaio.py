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
    lib.fasta_count.restype = ctypes.c_long
    lib.fasta_count.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.fasta_parse.restype = ctypes.c_long
    lib.fasta_parse.argtypes = [ctypes.c_char_p, ctypes.c_long, _U8P, _LONGP,
                                _LONGP, ctypes.c_long]
    return lib


def parse(buf: bytes, source: str = "<bytes>"):
    """Parse FASTA bytes -> FastaSet (the contract of parse_fasta_bytes)."""
    from slamem_tpu_torch.io.fasta import FastaSet

    if len(buf) == 0:
        raise ValueError(f"{source}: empty FASTA input")
    lib = _lib()
    nmax = lib.fasta_count(buf, len(buf))
    if nmax < 0:
        raise ValueError(f"{source}: not FASTA (no leading '>' header)")
    codes = np.empty(len(buf), dtype=np.uint8)
    seq_starts = np.empty(nmax + 1, dtype=np.int64)
    name_spans = np.empty(2 * nmax, dtype=np.int64)
    nseq = lib.fasta_parse(buf, len(buf), codes.ctypes.data_as(_U8P),
                           seq_starts.ctypes.data_as(_LONGP),
                           name_spans.ctypes.data_as(_LONGP), nmax)
    if nseq < 0:
        raise ValueError(f"{source}: malformed FASTA")
    names = [buf[off:off + ln].decode("ascii", "replace")
             for off, ln in name_spans[:2 * nseq].reshape(-1, 2).tolist()]
    return FastaSet(names=names, starts=seq_starts[:nseq].copy(),
                    lengths=np.diff(seq_starts[:nseq + 1]),
                    codes=codes[:int(seq_starts[nseq])].copy())

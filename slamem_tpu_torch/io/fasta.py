"""FASTA / multi-FASTA reading and nucleotide coding.

Capability parity with the reference's ``sequence.c``/``tools.c`` layer
(SURVEY.md §2): multi-FASTA parsing, sequence concatenation with boundary
tracking, A/C/G/T/N handling, reverse complement for the ``-b`` strand mode.

Design differences from the reference (which streams bytes in C):
  * parsing is numpy-vectorized over the whole file buffer (the JAX
    package's optional C parser, ``slamem_tpu/_native``, has the same
    contract and is not part of this package);
  * sequences are held as uint8 *code* arrays (A=0 C=1 G=2 T=3, any other
    letter=4 "N", inter-sequence separator=5), the layout every downstream
    stage (packing, index build, engines) consumes directly.

N / boundary policy (SURVEY.md §7 "N-handling semantics"): matches must never
span an N or a sequence boundary. Codes >= CODE_N are never matchable; the
index build assigns them unique sort ranks so no two suffixes compare equal
across them, and the query side masks out any seed window containing them.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

CODE_A = 0
CODE_C = 1
CODE_G = 2
CODE_T = 3
CODE_N = 4    # any non-ACGT letter
CODE_SEP = 5  # inter-sequence separator (never present inside a Sequence)

_BASES = "ACGT"

# 256-entry byte -> code lookup; IUPAC ambiguity codes and anything else -> N.
_CODE_LUT = np.full(256, CODE_N, dtype=np.uint8)
for _i, _b in enumerate(_BASES):
    _CODE_LUT[ord(_b)] = _i
    _CODE_LUT[ord(_b.lower())] = _i

# complement in code space: A<->T, C<->G, N->N, SEP->SEP
_COMP_LUT = np.array([CODE_T, CODE_G, CODE_C, CODE_A, CODE_N, CODE_SEP],
                     dtype=np.uint8)

_CODE_TO_CHAR = np.frombuffer(b"ACGTN|", dtype=np.uint8)


@dataclasses.dataclass
class Sequence:
    """One FASTA record: display name (first word of header) + code array."""

    name: str
    codes: np.ndarray  # uint8, values in {0..4}

    def __len__(self) -> int:
        return len(self.codes)


@dataclasses.dataclass
class FastaSet:
    """A parsed multi-FASTA file: concatenated codes + per-sequence extent.

    ``codes`` holds all sequences back to back **without** separators;
    ``starts[k] .. starts[k]+lengths[k]`` is sequence k. ``with_separators``
    materializes the separator-joined text used for index construction.
    """

    names: list[str]
    starts: np.ndarray   # int64, shape (num_seqs,)
    lengths: np.ndarray  # int64, shape (num_seqs,)
    codes: np.ndarray    # uint8, shape (total_length,)

    @property
    def num_seqs(self) -> int:
        return len(self.names)

    @property
    def total_length(self) -> int:
        return int(self.codes.shape[0])

    def sequence(self, k: int) -> Sequence:
        s, l = int(self.starts[k]), int(self.lengths[k])
        return Sequence(self.names[k], self.codes[s:s + l])

    def with_separators(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (text, seq_starts_in_text).

        ``text`` is the uint8 concatenation with one CODE_SEP between
        consecutive sequences (none at either end); ``seq_starts_in_text[k]``
        is where sequence k begins inside ``text``. A text position maps back
        to (seq id, local offset) via ``locate_in_text``.
        """
        if self.num_seqs == 1:
            return self.codes, np.zeros(1, dtype=np.int64)
        total = self.total_length + self.num_seqs - 1
        text = np.full(total, CODE_SEP, dtype=np.uint8)
        starts = self.starts + np.arange(self.num_seqs, dtype=np.int64)
        for k in range(self.num_seqs):
            s = int(starts[k])
            text[s:s + int(self.lengths[k])] = self.codes[
                int(self.starts[k]):int(self.starts[k]) + int(self.lengths[k])]
        return text, starts

    def locate_in_text(self, pos: np.ndarray,
                       text_starts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Map separator-joined text positions -> (seq_id, local 0-based pos)."""
        pos = np.asarray(pos, dtype=np.int64)
        seq_id = np.searchsorted(text_starts, pos, side="right") - 1
        return seq_id, pos - text_starts[seq_id]


def parse_fasta_bytes(buf: bytes, source: str = "<bytes>") -> FastaSet:
    """Parse a FASTA byte buffer into a FastaSet (numpy-vectorized)."""
    raw = np.frombuffer(buf, dtype=np.uint8)
    if raw.size == 0:
        raise ValueError(f"{source}: empty FASTA input")
    # Normalize: find line starts. Lines beginning with '>' are headers.
    nl = raw == ord("\n")
    line_starts = np.flatnonzero(np.concatenate(([True], nl[:-1])))
    # Drop a trailing empty "line" after a final newline.
    line_starts = line_starts[line_starts < raw.size]
    line_ends = np.concatenate((line_starts[1:], [raw.size]))
    is_header = raw[line_starts] == ord(">")
    if not is_header.any() or not is_header[0]:
        raise ValueError(f"{source}: not FASTA (no leading '>' header)")

    header_idx = np.flatnonzero(is_header)
    names: list[str] = []
    for h in header_idx:
        s, e = int(line_starts[h]), int(line_ends[h])
        line = buf[s + 1:e].split(b"\n", 1)[0].strip()
        # Reference behavior: sequence name = first whitespace-delimited word.
        names.append(line.split()[0].decode("ascii", "replace") if line else "")

    # Mask everything that isn't sequence payload: header lines + whitespace.
    keep = np.ones(raw.size, dtype=bool)
    for h in header_idx:
        keep[int(line_starts[h]):int(line_ends[h])] = False
    keep &= raw != ord("\n")
    keep &= raw != ord("\r")
    keep &= raw != ord(" ")
    keep &= raw != ord("\t")

    # Sequence id per byte: count of headers at or before the byte.
    hdr_marks = np.zeros(raw.size + 1, dtype=np.int64)
    hdr_marks[line_starts[header_idx]] = 1
    seq_of_byte = np.cumsum(hdr_marks[:-1]) - 1

    payload = np.flatnonzero(keep)
    codes = _CODE_LUT[raw[payload]]
    seq_ids = seq_of_byte[payload]
    lengths = np.bincount(seq_ids, minlength=len(names)).astype(np.int64)
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
    return FastaSet(names=names, starts=starts, lengths=lengths, codes=codes)


def read_fasta(path: str | os.PathLike) -> FastaSet:
    """Read a (multi-)FASTA file, transparently gunzipping .gz inputs."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"\x1f\x8b":  # gzip magic
        import gzip

        buf = gzip.decompress(buf)
    return parse_fasta_bytes(buf, str(path))


def write_fasta(path: str | os.PathLike, seqs: list[Sequence],
                width: int = 70) -> None:
    """Write sequences as FASTA (test-harness utility; no reference analog)."""
    with open(path, "w") as f:
        for s in seqs:
            f.write(f">{s.name}\n")
            txt = codes_to_str(s.codes)
            for i in range(0, len(txt), width):
                f.write(txt[i:i + width])
                f.write("\n")


def codes_to_str(codes: np.ndarray) -> str:
    return _CODE_TO_CHAR[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space (N maps to N)."""
    return _COMP_LUT[np.asarray(codes, dtype=np.uint8)][::-1].copy()

"""FASTA files of generated sequences, written a sequence at a time."""

from __future__ import annotations

import numpy as np

LETTERS = np.frombuffer(b"ACGTN", np.uint8)


def write_fasta(path: str, names: list[str], seqs: list[np.ndarray],
                width: int = 70) -> None:
    """Write the sequences (codes 0..4) in lines of ``width``."""
    with open(path, "wb") as f:
        for name, codes in zip(names, seqs):
            rows, rest = divmod(codes.size, width)
            body = np.empty((rows, width + 1), np.uint8)
            body[:, :width] = LETTERS[codes[:rows * width]].reshape(rows,
                                                                    width)
            body[:, width] = ord("\n")
            f.write(f">{name}\n".encode())
            f.write(body)
            if rest:
                f.write(LETTERS[codes[rows * width:]].tobytes() + b"\n")

"""Synthetic genome generators (SURVEY.md §4 item 5), numpy only.

A copy of ``slamem_tpu/utils/synth.py`` that needs no JAX, so the port can
make the bench inputs on a machine without it. Same seeds, same arrays
(tests/test_torch_index.py checks this).
"""

from __future__ import annotations

import numpy as np

from slamem_tpu_torch.io.fasta import CODE_N


def random_genome(n: int, seed: int = 0, gc: float = 0.5) -> np.ndarray:
    """Uniform-ish random genome as uint8 codes (A=0..T=3)."""
    rng = np.random.default_rng(seed)
    p_at = (1.0 - gc) / 2.0
    p_gc = gc / 2.0
    return rng.choice(4, size=n, p=[p_at, p_gc, p_gc, p_at]).astype(np.uint8)


def with_repeats(codes: np.ndarray, n_repeats: int, repeat_len: int,
                 seed: int = 1) -> np.ndarray:
    """Plant tandem/dispersed repeat copies to mimic genomic repeat content."""
    rng = np.random.default_rng(seed)
    out = codes.copy()
    n = out.size
    if n < 2 * repeat_len:
        return out
    for _ in range(n_repeats):
        src = int(rng.integers(0, n - repeat_len))
        dst = int(rng.integers(0, n - repeat_len))
        out[dst:dst + repeat_len] = out[src:src + repeat_len]
    return out


def mutate(codes: np.ndarray, sub_rate: float = 0.01, indel_rate: float = 0.001,
           seed: int = 2) -> np.ndarray:
    """Derive a diverged relative: substitutions + short indels.

    Models strain-level divergence (E. coli K-12 vs O157:H7 ~ 1-2% SNPs plus
    indels/islands) so MEM length statistics resemble the BASELINE scenarios.
    """
    rng = np.random.default_rng(seed)
    out = codes.copy()
    n = out.size
    # substitutions: pick positions, add 1..3 mod 4 so the base always changes
    n_sub = int(n * sub_rate)
    if n_sub:
        pos = rng.choice(n, size=n_sub, replace=False)
        out[pos] = (out[pos] + rng.integers(1, 4, size=n_sub)) % 4
    # indels: cut deletions and splice insertions
    n_indel = int(n * indel_rate)
    if n_indel:
        pieces = []
        cuts = np.sort(rng.choice(n, size=n_indel, replace=False))
        prev = 0
        for c in cuts:
            pieces.append(out[prev:c])
            if rng.random() < 0.5:  # deletion
                prev = min(n, c + int(rng.integers(1, 10)))
            else:  # insertion
                ins = rng.integers(0, 4, size=int(rng.integers(1, 10)))
                pieces.append(ins.astype(np.uint8))
                prev = c
        pieces.append(out[prev:])
        out = np.concatenate(pieces)
    return out


def with_n_runs(codes: np.ndarray, n_runs: int, run_len: int,
                seed: int = 3) -> np.ndarray:
    """Overwrite stretches with N (assembly-gap mimicry; N-policy tests)."""
    rng = np.random.default_rng(seed)
    out = codes.copy()
    n = out.size
    for _ in range(n_runs):
        if n <= run_len:
            break
        s = int(rng.integers(0, n - run_len))
        out[s:s + run_len] = CODE_N
    return out


def strain_pair(n: int, seed: int = 0, sub_rate: float = 0.015,
                indel_rate: float = 0.0015, n_repeats: int = 0,
                repeat_len: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(reference, diverged query) pair of roughly length n."""
    ref = random_genome(n, seed=seed)
    if n_repeats:
        ref = with_repeats(ref, n_repeats, repeat_len, seed=seed + 1)
    qry = mutate(ref, sub_rate=sub_rate, indel_rate=indel_rate, seed=seed + 2)
    return ref, qry

"""The listing a correct run prints, worked out from the generated inputs.

Format (MUMmer's, as slaMEM prints it): per query entry a line
``> <name>``, then one line per MEM ordered by query position, then
reference position, 1-based: ``%8d  %8d  %8d`` (reference position,
query position, length), or with several reference sequences
``  <name padded to the longest>  %8d  %8d  %8d``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.mems import ReferenceTable

SEPARATOR = 5


def joined(seqs: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """(text, starts): the sequences with one separator between each two."""
    starts = np.cumsum([0] + [s.size + 1 for s in seqs[:-1]])
    text = np.full(int(sum(s.size for s in seqs)) + len(seqs) - 1,
                   SEPARATOR, np.uint8)
    for s, a in zip(seqs, starts):
        text[a:a + s.size] = s
    return text, starts


def render(ref_names: list[str], query_names: list[str],
           matches: list[tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]]) -> str:
    """The listing text; ``matches[e]`` = (ref seq id, 0-based ref
    position, 0-based query position, length) of entry e, in order."""
    multi = len(ref_names) > 1
    width = max(len(n) for n in ref_names)
    out = []
    for name, (seq, r, q, length) in zip(query_names, matches):
        out.append(f"> {name}\n")
        rows = zip(seq.tolist(), (r + 1).tolist(), (q + 1).tolist(),
                   length.tolist())
        if multi:
            pad = [n.ljust(width) for n in ref_names]
            out.extend(f"  {pad[s]}  {a:>8}  {b:>8}  {c:>8}\n"
                       for s, a, b, c in rows)
        else:
            out.extend(f"{a:>8}  {b:>8}  {c:>8}\n" for _, a, b, c in rows)
    return "".join(out)


def expected_listing(ref_names: list[str], refs: list[np.ndarray],
                     query_names: list[str], queries: list[np.ndarray],
                     min_len: int, device: torch.device,
                     stride: int | None = None) -> tuple[str, int]:
    """(listing, number of MEMs) over every query entry; ``stride`` other
    than the plan's gives the control's listing."""
    text, starts = joined(refs)
    table = ReferenceTable(torch.from_numpy(text).to(device), min_len)
    matches, count = [], 0
    for qry in queries:
        r, q, length = (x.cpu().numpy() for x in table.find_mems(
            torch.from_numpy(qry).to(device), stride))
        seq = np.searchsorted(starts, r, side="right") - 1
        matches.append((seq, r - starts[seq], q, length))
        count += length.size
    del table
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return render(ref_names, query_names, matches), count

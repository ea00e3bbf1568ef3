"""Data-parallel seed-engine steps over a mesh (port of
``slamem_tpu/dist/seed.py``).

Every rank holds the whole index and the same frontend intervals, and
plans the same rounds from them. A round dispatches one query block per
rank: rank r expands block r of the group into sorted (diagonal, sample)
pairs and compacts them to run triples (or, on the boundary backend, to
start / end events) on its device; the ranks' triples are gathered in rank
order and the pair counts are summed, so every rank holds the same result.
A rank with no block in a group expands an empty one and still joins every
collective, in the same order as every other rank.
"""

from __future__ import annotations

import torch

from slamem_tpu_torch.dist.mesh import (Mesh, all_gather_ragged,
                                        all_reduce_sum)
from slamem_tpu_torch.engine.seed_mode import (StageClock,
                                               _compact_pair_runs,
                                               _expand_flags_core,
                                               _expand_pairs_core,
                                               _join_intervals)


def _mark(clock: StageClock | None, stage: str) -> None:
    if clock is not None:
        clock.mark(stage)


def _gather_runs(mesh: Mesh, d_s: torch.Tensor, q_s: torch.Tensor,
                 clock: StageClock | None):
    runs = torch.stack(_compact_pair_runs(d_s, q_s), 1)
    n = torch.tensor(d_s.shape[0], dtype=torch.int64, device=d_s.device)
    _mark(clock, "expand")
    runs, counts = all_gather_ragged(mesh, runs)
    total = all_reduce_sum(mesh, n)
    _mark(clock, "gather")
    return runs, counts, total


def expand_runs_gathered(mesh: Mesh, sa_aug: torch.Tensor, lo: torch.Tensor,
                         width: torch.Tensor, start: int, end: int,
                         m_off: int, stride: int = 1,
                         clock: StageClock | None = None):
    """This rank's block [start, end) of samples (empty: start == end)
    expanded, sorted and compacted to run triples on its device, then
    gathered. Returns (runs (R, 3) int32 (diag', qstart, qend) in rank
    order, the per-rank run counts, the pair count summed over the ranks
    (a device scalar)). A ``clock`` gets the stages ``expand`` and
    ``gather``."""
    d_s, q_s = _expand_pairs_core(sa_aug, lo[start:end], width[start:end],
                                  start, m_off, stride)
    return _gather_runs(mesh, d_s, q_s, clock)


def expand_boundaries_gathered(mesh: Mesh, text: torch.Tensor,
                               qt: torch.Tensor, sa_aug: torch.Tensor,
                               lo: torch.Tensor, width: torch.Tensor,
                               start: int, end: int, m_off: int, k: int,
                               clock: StageClock | None = None):
    """The boundary backend's events of this rank's block, gathered:
    (starts (S, 2), ends (E, 2)) int32 (diag', q) in rank order, and the
    pair count summed over the ranks. Run starts and ends are global
    properties of each pair, so no partition into blocks or ranks cuts a
    run."""
    sd, sq, ed, eq = _expand_flags_core(text, qt, sa_aug, lo[start:end],
                                        width[start:end], start, m_off, k)
    n = width[start:end].sum(dtype=torch.int64)
    _mark(clock, "expand")
    starts, _ = all_gather_ragged(mesh, torch.stack([sd, sq], 1))
    ends, _ = all_gather_ragged(mesh, torch.stack([ed, eq], 1))
    total = all_reduce_sum(mesh, n)
    _mark(clock, "gather")
    return starts, ends, total


def full_query_step(mesh: Mesh, refk: torch.Tensor, sa_aug: torch.Tensor,
                    qk: torch.Tensor, qvalid: torch.Tensor, q_start: int,
                    m_off: int):
    """One whole query step over the mesh: this rank's block of query keys
    (samples from ``q_start``) through the join frontend against the
    replicated table, expansion, pair sort and run compaction, then the
    gather of the triples and the sum of the pair counts (the program the
    JAX graft entry runs on n devices). Returns what expand_runs_gathered
    returns."""
    lo, width = _join_intervals(refk, qk, qvalid)
    d_s, q_s = _expand_pairs_core(sa_aug, lo, width, q_start, m_off)
    return _gather_runs(mesh, d_s, q_s, None)

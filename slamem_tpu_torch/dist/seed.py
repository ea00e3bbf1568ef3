"""Data-parallel seed-engine steps over a mesh (port of
``slamem_tpu/dist/seed.py``).

Every rank holds the whole index and the same frontend intervals, and
plans the same rounds from them (seed_mode.pairs_to_matches). A round
dispatches one query block per rank: rank r expands block r of the group
into sorted (diagonal, sample) pairs and compacts them to run triples (or,
on the boundary backend, to start / end events) on its device (stage
``expand``); the ranks' triples are gathered in rank order (stage
``gather``), so every rank holds the same result. A rank with no block in
a group expands an empty one and still joins every collective, in the
same order as every other rank.
"""

from __future__ import annotations

import torch

from slamem_tpu_torch.dist.mesh import (Mesh, all_gather_ragged,
                                        all_reduce_sum)
from slamem_tpu_torch.engine.seed_mode import (_compact_pair_runs,
                                               _expand_pairs_core,
                                               _fetch_events,
                                               _join_intervals,
                                               expand_block_to_boundaries,
                                               expand_block_to_runs)
from slamem_tpu_torch.utils.log import span


def expand_runs_gathered(mesh: Mesh, sa_aug: torch.Tensor, lo: torch.Tensor,
                         width: torch.Tensor, start: int, end: int,
                         m_off: int, stride: int = 1):
    """This rank's block [start, end) of samples (empty: start == end)
    expanded, sorted and compacted to run triples on its device, then
    gathered. Returns (run_d, run_qs, run_qe) int32 (diag', qstart,
    qend), every rank's in rank order."""
    with span("expand"):
        runs = torch.stack(expand_block_to_runs(sa_aug, lo, width, start,
                                                end, m_off, stride), 1)
    with span("gather"):
        return all_gather_ragged(mesh, runs)[0].unbind(1)


def expand_boundaries_gathered(mesh: Mesh, text: torch.Tensor,
                               qt: torch.Tensor, sa_aug: torch.Tensor,
                               lo: torch.Tensor, width: torch.Tensor,
                               start: int, end: int, m_off: int, k: int):
    """The boundary backend's events of this rank's block, gathered in rank
    order, then fetched to the host in one copy: int32 numpy (start diag',
    start q, end diag', end q). Run starts and ends are global properties
    of each pair, so no partition into blocks or ranks cuts a run."""
    with span("expand"):
        sd, sq, ed, eq = expand_block_to_boundaries(text, qt, sa_aug, lo,
                                                    width, start, end, m_off,
                                                    k)
        starts, ends = torch.stack([sd, sq], 1), torch.stack([ed, eq], 1)
    with span("gather"):
        starts, _ = all_gather_ragged(mesh, starts)
        ends, _ = all_gather_ragged(mesh, ends)
        return _fetch_events(*starts.unbind(1), *ends.unbind(1))


def full_query_step(mesh: Mesh, refk: torch.Tensor, sa_aug: torch.Tensor,
                    qk: torch.Tensor, qvalid: torch.Tensor, q_start: int,
                    m_off: int):
    """One whole query step over the mesh: this rank's block of query keys
    (samples from ``q_start``) through the join frontend against the
    replicated table, expansion, pair sort and run compaction, then the
    gather of the triples and the sum of the pair counts (the program the
    JAX graft entry runs on n devices). Returns (runs (R, 3) int32 (diag',
    qstart, qend) in rank order, the per-rank run counts, the pair count
    summed over the ranks (a device scalar))."""
    lo, width = _join_intervals(refk, qk, qvalid)
    d_s, q_s = _expand_pairs_core(sa_aug, lo, width, q_start, m_off)
    runs, counts = all_gather_ragged(
        mesh, torch.stack(_compact_pair_runs(d_s, q_s), 1))
    n = torch.tensor(d_s.shape[0], dtype=torch.int64, device=d_s.device)
    return runs, counts, all_reduce_sum(mesh, n)

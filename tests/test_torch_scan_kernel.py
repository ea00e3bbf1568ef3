"""The scan kernel's algorithm (one warp per lane, ``csrc/rank.cu``
``scan_lanes_kernel``) against the JAX package's lockstep scan, on the CPU.

A serial numpy model of the kernel runs one lane at a time: it skips steps
that are not live, expands only at the depth cap, skips the occ read when
c >= 4, and searches the PSV/NSV pyramid as the kernel does: each of 32
warp lanes holds 4 values of a 128-value block (while ascending, a lane
whose 4 values lie wholly on the far side of the position loads none and
holds INT32_MAX), reduces them to one candidate index, and one warp
maximum (PSV) or minimum (NSV) of the candidates gives the answer. It is
held to the JAX ``_scan_lanes`` (``rank_kernel="xla"`` and ``"nib"``) and
to the port's lockstep ``_scan_lanes``, and through them to the port's
routing. Tolerance: exact, on the FULL ``lo`` and ``width`` arrays (not only
where width > 0): both are integers that every position records once.
"""

import numpy as np
import pytest
import torch

from slamem_tpu.engine import scan_mode as jscan
from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.utils.synth import (mutate, random_genome, with_n_runs,
                                    with_repeats)

from slamem_tpu_torch.engine import scan_mode
from slamem_tpu_torch.index.build import build_index
from slamem_tpu_torch.io.fasta import CODE_SEP
from slamem_tpu_torch.kernels import rank

torch.set_num_threads(1)

F = 128
I32MAX = np.iinfo(np.int32).max


class SerialScan:
    """Per-lane serial model of ``scan_lanes_kernel`` over a JAX index.

    occ comes from per-character prefix counts of the BWT (independent of
    either table layout); the pyramid levels are the JAX package's.
    ``levels_climbed`` counts the searches that resolved above level 0, so
    a test can show that it reached the ascent and descent.
    """

    def __init__(self, jidx):
        bwt = np.asarray(jidx.bwt).astype(np.int64)
        self.n = int(jidx.n)
        self.counts = np.asarray(jidx.counts).astype(np.int64)
        self.occ = np.zeros((4, self.n + 1), np.int64)
        for c in range(4):
            self.occ[c, 1:] = np.cumsum(bwt == c)
        pyr = jscan.get_pyramid(jidx)
        self.levels = [np.asarray(lv).astype(np.int64) for lv in pyr.levels]
        self.levels_climbed = 0

    def _block(self, t, blk, want):
        """(32, 4): lane k's values 4k..4k+3 of block ``blk`` of level t,
        INT32_MAX outside the level and in the lanes that do not ``want``
        (32,) to load."""
        out = np.full(F, I32MAX, np.int64)
        if blk >= 0:
            take = self.levels[t][blk * F:blk * F + F]
            out[:take.size] = take
        return np.where(want[:, None], out.reshape(32, 4), I32MAX)

    @staticmethod
    def _last_below(x, upto, v):
        """Each lane's largest k <= upto of its 4 with x[k] < v (else -1),
        then the warp maximum (``__reduce_max_sync``)."""
        k = 4 * np.arange(32)[:, None] + np.arange(4)[None, :]
        return int(np.where((k <= upto) & (x < v), k, -1).max(1).max())

    @staticmethod
    def _first_below(x, frm, v):
        """Each lane's smallest k >= frm with x[k] < v (else 128), then the
        warp minimum (``__reduce_min_sync``)."""
        k = 4 * np.arange(32)[:, None] + np.arange(4)[None, :]
        return int(np.where((k >= frm) & (x < v), k, F).min(1).min())

    def _search(self, j, v, left):
        k = 4 * np.arange(32)
        every = np.ones(32, bool)
        pos, found, hit = j, -1, 0
        for t in range(len(self.levels)):       # ascend until a block hits
            blk = pos // F
            off = pos - blk * F
            if left:        # lanes wholly right of the position load nothing
                cand = self._last_below(self._block(t, blk, k <= off), off, v)
            else:
                cand = self._first_below(self._block(t, blk, k + 3 >= off),
                                         off, v)
            if (cand >= 0) if left else (cand < F):
                found, hit = t, blk * F + cand
                break
            pos = blk - 1 if left else blk + 1
        if found < 0:
            return 0
        self.levels_climbed += found > 0
        for t in range(found, 0, -1):           # descend to the exact index
            x = self._block(t - 1, hit, every)
            hit = hit * F + (self._last_below(x, F - 1, v) if left
                             else self._first_below(x, 0, v))
        return hit

    def _expand(self, l, r, v):
        return self._search(l, v, True), self._search(r, v, False)

    def scan(self, qt, L, B):
        m, n = len(qt), self.n
        lo = np.zeros(m, np.int64)
        w = np.zeros(m, np.int64)
        S = B + L
        lcp = self.levels[0]
        for g in range(-(-m // B)):
            l, r, d = 0, n, 0
            for step in range(S):
                i = g * B + S - 1 - step
                if i >= m:
                    continue
                c = int(qt[i])
                if d == L:
                    l, r = self._expand(l, r, L - 1)
                    d = L - 1
                while True:
                    if c < 4:
                        l2 = self.counts[c] + self.occ[c, l]
                        r2 = self.counts[c] + self.occ[c, r]
                        if l2 < r2:
                            l, r, d = l2, r2, d + 1
                            break
                    if d == 0:
                        l, r = 0, n
                        break
                    pd = max(lcp[l], lcp[r], 0)
                    l, r = self._expand(l, r, pd)
                    d = pd
                if step >= L:
                    lo[i] = l
                    w[i] = r - l if d == L else 0
        return lo, w


def _joined(seqs):
    """One multi-entry query: sequences joined by separator codes."""
    parts = []
    for s in seqs:
        parts += [s, np.array([CODE_SEP], np.uint8)]
    return np.concatenate(parts[:-1])


def _inputs(kind):
    ref = with_n_runs(random_genome(3000, seed=62), 3, 20, seed=63)
    if kind == "n_runs":
        qry = with_n_runs(mutate(ref, 0.03, 0.003, seed=64), 2, 15, seed=65)
    elif kind == "multi_entry":
        mut = mutate(ref, 0.02, 0.002, seed=66)
        qry = _joined([mut[100:900], mut[1500:1530], mut[2000:2900]])
    elif kind == "shorter_than_a_lane":
        qry = mutate(ref, 0.02, 0.002, seed=67)[500:700]
    else:   # "ragged_last_lane": the last lane's early steps lie past m
        qry = mutate(ref, 0.02, 0.002, seed=68)[:2 * 256 + 37]
    return ref, qry


def _assert_full_equal(name, got, want):
    lo_g, w_g = (np.asarray(a).astype(np.int64) for a in got)
    lo_w, w_w = want
    assert np.array_equal(w_g, w_w), f"{name}: width differs"
    assert np.array_equal(lo_g, lo_w), f"{name}: lo differs"


@pytest.mark.parametrize("kind", ["n_runs", "multi_entry",
                                  "shorter_than_a_lane", "ragged_last_lane"])
@pytest.mark.parametrize("L,lane_block", [(9, 256), (12, 64), (25, 32)])
def test_serial_model_equals_jax_and_lockstep(kind, L, lane_block):
    ref, qry = _inputs(kind)
    jidx, tidx = jax_build(ref), build_index(ref, device="cpu")
    want = SerialScan(jidx).scan(qry, L, lane_block)
    assert (want[1] > 0).sum() > 0
    for rk in ("xla", "nib"):
        _assert_full_equal(f"jax {rk}", jscan.scan_intervals(
            jidx, qry, L, lane_block=lane_block, rank_kernel=rk), want)
    for rk in ("auto", "pallas", "xla"):
        _assert_full_equal(f"port lockstep {rk}", scan_mode.scan_intervals(
            tidx, qry, L, lane_block=lane_block, rank_kernel=rk), want)


def test_serial_model_climbs_the_pyramid():
    """A reference with three pyramid levels and planted repeats: searches
    resolve above level 0 (ascent and descent), and the model still equals
    the JAX scan and the port's lockstep loop."""
    ref = with_repeats(with_n_runs(random_genome(20_000, seed=91), 3, 30,
                                   seed=92), 12, 300, seed=93)
    qry = _joined([with_n_runs(mutate(ref, 0.02, 0.002, seed=94)[:1500], 2,
                               12, seed=95), mutate(ref, 0.05, 0.0, seed=96)
                   [9000:9700]])
    jidx, tidx = jax_build(ref), build_index(ref, device="cpu")
    model = SerialScan(jidx)
    assert len(model.levels) == 3
    want = model.scan(qry, 14, 64)
    assert model.levels_climbed > 0
    _assert_full_equal("jax xla", jscan.scan_intervals(
        jidx, qry, 14, lane_block=64, rank_kernel="xla"), want)
    _assert_full_equal("port lockstep", scan_mode.scan_intervals(
        tidx, qry, 14, lane_block=64), want)


@pytest.mark.parametrize("layout", ["k0", "nib"])
def test_scan_lanes_on_cpu_runs_the_plain_loop(layout):
    """The kernel wrapper on CPU tensors takes the plain lockstep loop over
    the layout's plain occ, equal to the serial model; its argument checks
    refuse what the kernel does not take."""
    ref, qry = _inputs("n_runs")
    jidx, tidx = jax_build(ref), build_index(ref, device="cpu")
    rows = (rank.nibble_rows if layout == "nib" else
            rank.interleaved_rows)(tidx)
    pyr = scan_mode.get_pyramid(tidx)
    qt = torch.from_numpy(qry)
    before = dict(rank.scan_lanes.launches)
    got = rank.scan_lanes(rows, layout, tidx.counts, pyr, qt, 12, 64)
    _assert_full_equal("scan_lanes cpu", got, SerialScan(jidx).scan(
        qry, 12, 64))
    assert rank.scan_lanes.launches == before    # no kernel on the CPU
    bad = [dict(layout="k1"), dict(qt=qt.to(torch.int32)),
           dict(rows=rows[1:]), dict(counts=tidx.counts.to(torch.int64)),
           dict(L=0), dict(pyr=type(pyr)(levels=pyr.levels * 5, n=pyr.n)),
           dict(pyr=type(pyr)(levels=(pyr.levels[0][1:],), n=pyr.n))]
    args = dict(rows=rows, layout=layout, counts=tidx.counts, pyr=pyr, qt=qt,
                L=12, lane_block=64)
    for change in bad:
        with pytest.raises(ValueError):
            rank.scan_lanes(**{**args, **change})


def test_cpu_index_routes_to_the_lockstep_loop(monkeypatch):
    """On a CPU index every rank_kernel value runs ``_scan_lanes`` and never
    the kernel wrapper; a value the JAX package does not name runs the
    nibble path there, as in the JAX package's ``_want_pallas``."""
    ref, qry = _inputs("n_runs")
    tidx = build_index(ref, device="cpu")
    calls = []
    real = scan_mode._scan_lanes
    monkeypatch.setattr(scan_mode, "_scan_lanes",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def no_kernel(*a, **k):
        raise AssertionError("scan_lanes called for a CPU index")

    monkeypatch.setattr(scan_mode, "scan_lanes", no_kernel)
    for rk in ("auto", "nib", "pallas", "pallas_interpret", "xla"):
        scan_mode.scan_intervals(tidx, qry, 12, lane_block=64,
                                 rank_kernel=rk)
    assert len(calls) == 5
    got = scan_mode.scan_intervals(tidx, qry, 12, lane_block=64,
                                   rank_kernel="nibble")
    assert len(calls) == 6
    want = scan_mode.scan_intervals(tidx, qry, 12, lane_block=64,
                                    rank_kernel="nib")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

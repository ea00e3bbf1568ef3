"""Port vs JAX package: scan-engine intervals, the shared pair/run backend,
and scan matches.

Same inputs (numpy, from seeds) go through both packages on the CPU; the
JAX scan reaches the Pallas rank kernel in interpret mode
(``rank_kernel="pallas_interpret"``), its XLA twin (``"xla"``, the same
semantics) or the nibble-SWAR path (``"auto"`` / ``"nib"``). Tolerance:
exact — intervals (lo where width > 0, and width), run triples, boundary
events and match tuples are integers and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamem_tpu.config import Config as JaxConfig
from slamem_tpu.config import MatchMode as JaxMode
from slamem_tpu.engine import scan_mode as jscan
from slamem_tpu.engine import seed_mode as jseed
from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.utils.synth import mutate, random_genome, with_n_runs

from slamem_tpu_torch.config import Config, MatchMode
from slamem_tpu_torch.engine import scan_mode, seed_mode
from slamem_tpu_torch.index.build import build_index

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)


def _tuples(m):
    return sorted(zip(m.refpos.tolist(), m.qpos.tolist(), m.length.tolist()))


def _assert_same_intervals(lo_j, w_j, lo_t, w_t):
    w_j = np.asarray(w_j)
    assert np.array_equal(w_j, w_t.numpy())
    sel = w_j > 0
    assert np.array_equal(np.asarray(lo_j)[sel], lo_t.numpy()[sel])


@pytest.mark.parametrize("rank_kernel", ["auto", "nib", "pallas",
                                         "pallas_interpret", "xla"])
def test_scan_intervals_equal_jax_pallas_interpret(rank_kernel):
    # the input of tests/test_rank_kernel.py::test_scan_engine_through_pallas_rank
    ref = with_n_runs(random_genome(1500, seed=144), 2, 25, seed=145)
    qry = random_genome(700, seed=146)
    jidx, tidx = jax_build(ref), build_index(ref, device="cpu")
    lo_j, w_j = jscan.scan_intervals(jidx, qry, 12, lane_block=64,
                                     rank_kernel="pallas_interpret")
    lo_t, w_t = scan_mode.scan_intervals(tidx, qry, 12, lane_block=64,
                                         rank_kernel=rank_kernel)
    assert lo_t.dtype == torch.int32 and w_t.shape == (700,)
    _assert_same_intervals(lo_j, w_j, lo_t, w_t)


@pytest.mark.parametrize("L,lane_block", [(12, 64), (9, 256), (25, 32)])
def test_scan_intervals_with_hits_equal_jax(L, lane_block):
    ref = with_n_runs(random_genome(3000, seed=62), 3, 20, seed=63)
    qry = with_n_runs(mutate(ref, 0.03, 0.003, seed=64), 2, 15, seed=65)
    jidx, tidx = jax_build(ref), build_index(ref, device="cpu")
    lo_j, w_j = jscan.scan_intervals(jidx, qry, L, lane_block=lane_block,
                                     rank_kernel="xla")
    lo_t, w_t = scan_mode.scan_intervals(tidx, qry, L, lane_block=lane_block)
    assert int((w_t > 0).sum()) > len(qry) // 4
    _assert_same_intervals(lo_j, w_j, lo_t, w_t)


def test_nib_and_auto_run_the_nibble_table():
    """rank_kernel "nib" and "auto" both run the nibble table (the JAX
    package's _want_pallas resolution): intervals equal the JAX nib scan's.
    A value neither package names runs the nibble path in both."""
    ref = with_n_runs(random_genome(2500, seed=1), 2, 20, seed=3)
    qry = with_n_runs(mutate(ref, 0.03, 0.003, seed=2), 2, 10, seed=4)
    jidx, tidx = jax_build(ref), build_index(ref, device="cpu")
    lo_j, w_j = jscan.scan_intervals(jidx, qry, 10, rank_kernel="nib")
    for rk in ("nib", "auto"):
        lo_t, w_t = scan_mode.scan_intervals(tidx, qry, 10, rank_kernel=rk)
        _assert_same_intervals(lo_j, w_j, lo_t, w_t)
    assert "rank_rows_nib" in tidx.derived
    assert "rank_rows" not in tidx.derived     # K0's table was never built
    lo_j2, w_j2 = jscan.scan_intervals(jidx, qry, 10, rank_kernel="nibble")
    lo_t, w_t = scan_mode.scan_intervals(tidx, qry, 10, rank_kernel="nibble")
    _assert_same_intervals(lo_j2, w_j2, lo_t, w_t)
    assert "rank_rows" not in tidx.derived


@pytest.mark.parametrize("rank_kernel", ["auto", "nib", "pallas"])
def test_find_scan_matches_rank_kernels_equal_jax(rank_kernel):
    """The scan's match set through each rank path == the JAX package's
    find_scan_matches through its default ("auto" = nib)."""
    ref = with_n_runs(random_genome(3000, seed=72), 3, 20, seed=73)
    ref[2000:2300] = ref[400:700]
    qry = with_n_runs(mutate(ref, 0.02, 0.002, seed=74), 2, 15, seed=75)
    jcfg = JaxConfig(min_length=14, engine="scan")
    tcfg = Config(min_length=14, engine="scan", rank_kernel=rank_kernel)
    want = _tuples(jscan.find_scan_matches(jax_build(ref), qry, jcfg))
    got = _tuples(scan_mode.find_scan_matches(
        build_index(ref, device="cpu"), qry, tcfg))
    assert got == want and len(want) > 0


@pytest.mark.parametrize("L,mode", [(11, "mem"), (20, "mem"), (12, "mum"),
                                    (12, "mam")])
def test_find_scan_matches_equal_jax(L, mode):
    ref = with_n_runs(random_genome(2500, seed=68), 3, 20, seed=69)
    ref[1200:1500] = ref[300:600]  # a repeat: MUM/MAM drop some matches
    qry = with_n_runs(mutate(ref, 0.015, 0.0015, seed=70), 2, 15, seed=71)
    jcfg = JaxConfig(min_length=L, mode=JaxMode(mode), engine="scan",
                     rank_kernel="xla")
    tcfg = Config(min_length=L, mode=MatchMode(mode), engine="scan")
    want = _tuples(jseed.apply_mode_filter(
        jscan.find_scan_matches(jax_build(ref), qry, jcfg), jcfg))
    got = _tuples(seed_mode.apply_mode_filter(
        scan_mode.find_scan_matches(build_index(ref, device="cpu"), qry,
                                    tcfg), tcfg))
    assert got == want and len(want) > 0


def test_scan_chunked_equals_monolithic(monkeypatch):
    """L-overlap chunks (several, including a short tail) == one chunk."""
    ref = random_genome(6000, seed=771)
    qry = mutate(ref, 0.02, 0.002, seed=772)
    tidx = build_index(ref, device="cpu")
    cfg = Config(min_length=12, engine="scan")
    want = _tuples(scan_mode.find_scan_matches(tidx, qry, cfg))
    monkeypatch.setattr(scan_mode, "_SCAN_CHUNK", 1536)
    got = _tuples(scan_mode.find_scan_matches(tidx, qry, cfg))
    assert got == want and len(want) > 0


def test_pair_runs_equal_jax_per_block():
    """Expansion + pair sort + run compaction of one block == JAX's
    fixed-capacity expand_block_to_runs (its first n_runs rows), and the
    raw sorted pairs == JAX's expand_block_pairs (valid prefix)."""
    ref = random_genome(3000, seed=80)
    ref[2000:2400] = ref[100:500]
    qry = mutate(ref, 0.02, 0.002, seed=81)
    L = 14
    jidx, tidx = jax_build(ref), build_index(ref, device="cpu")
    lo_j, w_j = jscan.scan_intervals(jidx, seed_mode.pad_query(qry), L,
                                     rank_kernel="xla")
    lo = torch.from_numpy(np.array(lo_j))
    w = torch.from_numpy(np.array(w_j))
    m = int(lo.shape[0])
    start, end, block, cap = 700, 2100, m, 1 << 14
    m_off = (m + block + 2) // 2
    pad = jnp.zeros((block,), jnp.int32)
    lo_ext, w_ext = jnp.concatenate([lo_j, pad]), jnp.concatenate([w_j, pad])
    args = (jidx.sa, lo_ext, w_ext, jnp.asarray(start, jnp.int64),
            jnp.asarray(end, jnp.int64), jnp.asarray(m_off, jnp.int32))
    jd, jqs, jqe, jn, _ = jseed.expand_block_to_runs(*args, cap, 4096, block)
    td, tqs, tqe = seed_mode.expand_block_to_runs(tidx.sa, lo, w, start, end,
                                                  m_off)
    nr = int(jn)
    assert nr == td.shape[0] > 0
    for a, b in ((jd, td), (jqs, tqs), (jqe, tqe)):
        assert np.array_equal(np.asarray(a)[:nr], b.numpy())
    jds, jqs2 = jseed.expand_block_pairs(*args, cap, block)
    tds, tqs2 = seed_mode.expand_block_pairs(tidx.sa, lo, w, start, end, m_off)
    npairs = int(w[start:end].sum())
    assert tds.shape[0] == npairs
    assert np.array_equal(np.asarray(jds)[:npairs], tds.numpy())
    assert np.array_equal(np.asarray(jqs2)[:npairs], tqs2.numpy())
    assert (np.asarray(jds)[npairs:] == np.iinfo(np.int32).max).all()
    # the host decode of raw pairs gives the same runs
    rb = seed_mode.runs_from_sorted_pairs(tds.numpy(), tqs2.numpy(), m_off)
    assert np.array_equal(rb.diag, td.numpy().astype(np.int64) - m_off)
    assert np.array_equal(rb.qend, tqe.numpy())


def test_multi_round_backend_equals_one_round():
    """A tiny pair capacity splits the query into many rounds; merged runs
    give the same matches as one round, as do the boundary backend's
    events; an interval wider than the capacity is refused as in the JAX
    package."""
    ref = random_genome(4000, seed=90)
    ref[3000:3500] = ref[200:700]
    qry = mutate(ref, 0.01, 0.001, seed=91)
    tidx = build_index(ref, device="cpu")
    want = _tuples(scan_mode.find_scan_matches(
        tidx, qry, Config(min_length=15, engine="scan")))
    got = _tuples(scan_mode.find_scan_matches(
        tidx, qry, Config(min_length=15, engine="scan", pair_capacity=64)))
    assert got == want and len(want) > 0
    lo = torch.zeros(4, dtype=torch.int32)
    w = torch.tensor([1, 9, 1, 0], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="pair_capacity"):
        seed_mode.pairs_to_matches(tidx, lo, w, 15, 4,
                                   Config(pair_capacity=8))
    # the boundary backend: events instead of sorted pairs, same matches,
    # one round or many; a backend name the JAX package does not know runs
    # the sort backend in both packages
    for cap in (1 << 22, 64):
        got = _tuples(scan_mode.find_scan_matches(tidx, qry, Config(
            min_length=15, engine="scan", pair_capacity=cap,
            match_backend="boundary")))
        assert got == want
    jwant = _tuples(jscan.find_scan_matches(jax_build(ref), qry, JaxConfig(
        min_length=15, engine="scan", rank_kernel="xla",
        match_backend="flags")))
    got = _tuples(scan_mode.find_scan_matches(tidx, qry, Config(
        min_length=15, engine="scan", match_backend="flags")))
    assert got == jwant == want

"""Port vs JAX package: the virtual-slab sharded seed engine (``-shard
-slabs n`` on one device), stage by stage and end to end.

The same numpy inputs (from seeds) go through ``slamem_tpu.dist.sharded``
and ``slamem_tpu_torch.dist.sharded`` on the CPU; the JAX sharded path is
all XLA (no Pallas). The port's index is the JAX index carried across with
``index_from_numpy``. Tolerance: exact — slab tables, intervals, run
triples and match tuples are integers and must be equal.

At K >= 15 word 0 spans 2^32 prefixes, and the default 3 GiB table budget
builds 1-2 GiB of ranged tables whatever the reference size, so the cases
with such K pass both packages a smaller ``max_table_bytes`` (which also
drives the bracket-and-refine branch, probes > 0).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamem_tpu.config import Config as JaxConfig
from slamem_tpu.config import MatchMode as JaxMode
from slamem_tpu.dist import sharded as jsh
from slamem_tpu.engine import seed_mode as jseed
from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.utils.devcache import clear_device_caches
from slamem_tpu.utils.synth import mutate, random_genome, with_n_runs

from slamem_tpu_torch.config import Config, MatchMode
from slamem_tpu_torch.dist import sharded
from slamem_tpu_torch.engine import seed_mode
from slamem_tpu_torch.index.serialize import index_from_numpy

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

_FIELDS = ("text", "sa", "bwt", "occ_ckpt", "counts")
_DEFAULT_BUDGET = 3 << 30


def _port_index(jidx):
    return index_from_numpy({f: np.asarray(getattr(jidx, f))
                             for f in _FIELDS}, jidx.occ_block, "cpu")


def _tuples(m):
    return sorted(zip(m.refpos.tolist(), m.qpos.tolist(), m.length.tolist()))


@pytest.fixture(autouse=True)
def _drop_jax_tables():
    """The JAX package caches slab tables per (index, K, slab count) but
    not per budget, and holds them until evicted: start and end each test
    without them."""
    clear_device_caches()
    yield
    clear_device_caches()


@pytest.fixture(scope="module")
def pair():
    ref = with_n_runs(random_genome(12_000, seed=501), 2, 40, seed=502)
    qry = with_n_runs(mutate(ref, 0.02, 0.002, seed=503), 2, 30, seed=504)
    jidx = jax_build(ref)
    return ref, jseed.pad_query(qry), jidx, _port_index(jidx)


# (k, max_table_bytes): one-word K with direct per-slab tables (shift 0,
# no probes); one-word K coarsened by a small budget (shift > 0, probes);
# two-word K, whose 32-bit word 0 always needs a shift and probes
TABLE_CASES = {"k10_direct": (10, _DEFAULT_BUDGET),
               "k10_small_budget": (10, 1 << 16),
               "k24_two_words": (24, 1 << 20)}


@pytest.mark.parametrize("n_slabs", [2, 3, 8])
@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_virtual_slab_tables_equal_jax(pair, case, n_slabs):
    _, _, jidx, tidx = pair
    k, budget = TABLE_CASES[case]
    (_jrefk, jsa, jstarts, jbases, jlasts, jshift, jprobes,
     jslab) = jsh.virtual_slab_tables(jidx, k, n_slabs, budget)
    (refk_p, sa_p, starts, bases, lasts, shift, probes,
     slab) = sharded.virtual_slab_tables(tidx, k, n_slabs, budget)
    assert (shift, probes, slab) == (jshift, jprobes, jslab)
    assert (shift == 0 and probes == 0) == (case == "k10_direct")
    assert starts.dtype == torch.int32
    assert np.array_equal(np.asarray(jstarts), starts.numpy())
    assert np.array_equal(np.asarray(jbases), bases.numpy())
    assert np.array_equal(np.asarray(jlasts), lasts.numpy())
    assert np.array_equal(np.asarray(jsa), sa_p.numpy())
    assert refk_p.shape == (n_slabs * slab,)
    assert bool((refk_p[1:] >= refk_p[:-1]).all())   # pads sort last
    assert sharded.virtual_slab_tables(tidx, k, n_slabs, budget)[2] is starts


@pytest.mark.parametrize("case,n_slabs,stride", [
    ("k10_direct", 3, 1), ("k10_direct", 8, 4),
    ("k10_small_budget", 3, 1), ("k24_two_words", 8, 5)])
def test_virtual_frontend_equal_jax(pair, case, n_slabs, stride):
    """Owner routing (probes == 0) and the per-slab bracket + refine
    (probes > 0): lo, w, cum and summary all equal."""
    _, qp, jidx, tidx = pair
    k, budget = TABLE_CASES[case]
    jt = jsh.virtual_slab_tables(jidx, k, n_slabs, budget)
    tt = sharded.virtual_slab_tables(tidx, k, n_slabs, budget)
    want = jsh.virtual_frontend(jt[0], jt[2], jt[3], jt[4], jnp.asarray(qp),
                                n_slabs, jt[7], k, jt[5], jt[6], stride)
    got = sharded.virtual_frontend(tt[0], tt[2], tt[3], tt[4],
                                   torch.from_numpy(qp), n_slabs, tt[7], k,
                                   tt[5], tt[6], stride)
    for name, a, b in zip(("lo", "w", "cum", "summary"), want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    assert got[0].dtype == got[1].dtype == torch.int32
    assert int(got[3][0]) > 0 and int((got[1] > 0).sum(1).min()) > 0


def _fragments(seed: int, n_slabs: int):
    """Runs on random diagonals, each cut into consecutive fragments that
    land on random slabs (any partition of a run's samples), plus runs
    that miss abutting by one sample and must stay apart."""
    rng = np.random.default_rng(seed)
    frags = []
    for _ in range(300):
        d = int(rng.integers(1000, 1060))
        qs = int(rng.integers(0, 5000))
        cuts = np.sort(rng.choice(np.arange(1, 12), rng.integers(0, 4),
                                  replace=False))
        bounds = [0, *cuts.tolist(), 12]
        for a, b in zip(bounds[:-1], bounds[1:]):
            frags.append((d, qs + a, qs + b - 1, int(rng.integers(n_slabs))))
        frags.append((d, qs + 13, qs + 13 + int(rng.integers(0, 3)),
                      int(rng.integers(n_slabs))))
    # a (diag, qstart) is unique, as pairs are partitioned by SA row
    uniq = {(f[0], f[1]): f for f in frags}
    frags = np.array(list(uniq.values()), dtype=np.int64)
    return frags[rng.permutation(len(frags))]


@pytest.mark.parametrize("w_min", [1, 5, 12])
def test_merge_slab_runs_equal_jax(w_min):
    n_slabs = 5
    frags = _fragments(507 + w_min, n_slabs)
    per = [frags[frags[:, 3] == i, :3] for i in range(n_slabs)]
    rc = max(len(p) for p in per) + 3
    pad = np.full((n_slabs, rc, 3), -7, np.int32)
    for i, p in enumerate(per):
        pad[i, :len(p)] = p
    n_runs = np.array([len(p) for p in per], np.int32)
    out_d, out_qs, out_qe, _n_merged, n_kept = jsh.merge_slab_runs(
        jnp.asarray(pad[..., 0]), jnp.asarray(pad[..., 1]),
        jnp.asarray(pad[..., 2]), jnp.asarray(n_runs), len(frags), w_min)
    n_kept = int(n_kept)
    flat = torch.from_numpy(np.concatenate(per).astype(np.int32))
    got = sharded.merge_slab_runs(flat[:, 0].contiguous(),
                                  flat[:, 1].contiguous(),
                                  flat[:, 2].contiguous(), w_min)
    for a, b in zip((out_d, out_qs, out_qe), got):
        assert b.dtype == torch.int32
        assert np.array_equal(np.asarray(a)[:n_kept], b.numpy())
    assert 0 < n_kept < len(frags)


def _poly_a_pair():
    """A K-mer class (poly-A) larger than a slab: interior slabs' intervals
    are the whole slab."""
    rng = np.random.default_rng(77)
    ref = np.concatenate([rng.integers(0, 4, 1_000).astype(np.uint8),
                          np.zeros(6_000, np.uint8),
                          rng.integers(0, 4, 1_000).astype(np.uint8)])
    qry = np.concatenate([rng.integers(0, 4, 500).astype(np.uint8),
                          np.zeros(300, np.uint8),
                          mutate(ref[:2_000], 0.02, 0.002, seed=78)])
    return ref, qry


def _tiny_pair():
    ref = random_genome(300, seed=661)
    return ref, mutate(ref, 0.02, 0.0, seed=662)


def _main_pair():
    ref = with_n_runs(random_genome(12_000, seed=501), 2, 40, seed=502)
    qry = with_n_runs(mutate(ref, 0.02, 0.002, seed=503), 2, 30, seed=504)
    return ref, qry


def _repeat_pair():
    """A tandem duplication makes some MEMs non-unique (MUM / MAM)."""
    ref = with_n_runs(random_genome(3000, seed=86), 2, 30, seed=87)
    ref = np.concatenate([ref, ref[500:900]])
    return ref, with_n_runs(mutate(ref, 0.02, 0.002, seed=88), 2, 20,
                            seed=89)


# case -> (input, n_slabs, Config fields, table budget, modes compared).
# At 64 and 301 slabs the JAX virtual path takes 7-26 s on the CPU (each
# slab's expansion is 2^18 slots wide there), so those two cases hold the
# port to the JAX replicated engine, to which tests/test_sharded.py holds
# the JAX virtual path.
E2E = {
    "slabs2": (_main_pair, 2, dict(min_length=14), None, ("mem",)),
    "slabs3": (_main_pair, 3, dict(min_length=14), None, ("mem",)),
    "slabs8": (_main_pair, 8, dict(min_length=14), None, ("mem",)),
    "rows_lt_slabs7": (_tiny_pair, 7, dict(min_length=10), None, ("mem",)),
    "rows_lt_slabs64": (_tiny_pair, 64, dict(min_length=10), None,
                        ("mem",)),
    "rows_lt_slabs301": (_tiny_pair, 301, dict(min_length=10), None,
                         ("mem",)),
    "class_spans_slabs": (_poly_a_pair, 8, dict(min_length=14), None,
                          ("mem",)),
    "mum_mam": (_repeat_pair, 4, dict(min_length=14), None,
                ("mem", "mum", "mam")),
    "deep_min_length": (_main_pair, 4, dict(min_length=40), 1 << 20,
                        ("mem",)),
    "multi_block": (_main_pair, 8, dict(min_length=14, pair_capacity=100),
                    None, ("mem",)),
}
_JAX_REPLICATED = {"rows_lt_slabs64", "rows_lt_slabs301"}


@pytest.mark.parametrize("case", sorted(E2E))
def test_virtual_slabs_match_jax_and_replicated(monkeypatch, case):
    make, n_slabs, fields, budget, modes = E2E[case]
    ref, qry = make()
    if budget is not None:
        for mod in (jsh, sharded):
            monkeypatch.setattr(mod, "virtual_slab_tables", functools.partial(
                mod.virtual_slab_tables, max_table_bytes=budget))
    jidx = jax_build(ref)
    tidx = _port_index(jidx)
    if case in _JAX_REPLICATED:
        jm = jseed.find_seed_matches(jidx, qry, JaxConfig(**fields))
    else:
        jm = jsh.find_seed_matches_sharded(jidx, qry, JaxConfig(**fields),
                                           None, n_slabs=n_slabs)
        assert jm.stats["virtual_slabs"] is True
    tm = sharded.find_seed_matches_sharded(tidx, qry, Config(**fields),
                                           n_slabs=n_slabs)
    rep = seed_mode.find_seed_matches(tidx, qry, Config(**fields))
    for mode in modes:
        cfg = Config(**fields, mode=MatchMode(mode))
        jcfg = JaxConfig(**fields, mode=JaxMode(mode))
        got = _tuples(seed_mode.apply_mode_filter(tm, cfg))
        assert got == _tuples(jseed.apply_mode_filter(jm, jcfg)), mode
        assert got == _tuples(seed_mode.apply_mode_filter(rep, cfg)), mode
        assert len(got) > 0, mode
    st = tm.stats
    assert st["shards"] == n_slabs and st["virtual_slabs"] is True
    assert (st["k"], st["stride"]) == (jm.stats["k"], jm.stats["stride"])
    if case not in _JAX_REPLICATED:
        assert st["pairs"] == jm.stats["pairs"] > 0
    assert (st["rounds"] > 1) == (case == "multi_block")
    stages = {"upload", "slab_tables", "slab_frontend", "slab_expand",
              "slab_merge", "merge"} | ({"extend"} if st["stride"] > 1
                                       else set())
    assert set(st["stage_s"]) == stages


def test_virtual_slabs_two_word_seeds(monkeypatch):
    """Two-word keys (K = 24, stride 1) end to end, the depth forced in
    both packages' seed planners as in tests/test_sharded.py."""
    force = lambda n, m, L, cap: min(L, cap)  # noqa: E731
    for mod in (jseed, seed_mode):
        monkeypatch.setattr(mod, "choose_seed_k", force)
        monkeypatch.setattr(mod, "choose_seed_k_sparse", force)
    for mod in (jsh, sharded):
        monkeypatch.setattr(mod, "virtual_slab_tables", functools.partial(
            mod.virtual_slab_tables, max_table_bytes=1 << 20))
    ref = with_n_runs(random_genome(5000, seed=90), 2, 40, seed=91)
    qry = with_n_runs(mutate(ref, 0.015, 0.0015, seed=92), 2, 25, seed=93)
    jidx = jax_build(ref)
    tidx = _port_index(jidx)
    jm = jsh.find_seed_matches_sharded(jidx, qry, JaxConfig(min_length=24),
                                       None, n_slabs=3)
    tm = sharded.find_seed_matches_sharded(tidx, qry, Config(min_length=24),
                                           n_slabs=3)
    rep = seed_mode.find_seed_matches(tidx, qry, Config(min_length=24))
    assert (tm.stats["k"], tm.stats["stride"]) == (24, 1)
    assert tm.stats["probes"] > 0
    assert _tuples(tm) == _tuples(jm) == _tuples(rep)
    assert len(_tuples(rep)) > 0


@pytest.mark.parametrize("n_slabs", [None, 1])
def test_one_slab_is_replicated(pair, n_slabs):
    ref, qp, _, tidx = pair
    cfg = Config(min_length=14)
    got = sharded.find_seed_matches_sharded(tidx, qp, cfg, n_slabs=n_slabs)
    want = seed_mode.find_seed_matches(tidx, qp, cfg)
    assert _tuples(got) == _tuples(want) and len(_tuples(want)) > 0
    assert "virtual_slabs" not in got.stats

"""Port vs JAX package: the seed engine, stage by stage and end to end.

The same numpy inputs (from seeds) go through ``slamem_tpu`` and
``slamem_tpu_torch`` on the CPU; the JAX seed path is all XLA (no Pallas).
The port's index is the JAX index carried across with ``index_from_numpy``.
Tolerance: exact — keys, intervals, tables, extension bounds and match
tuples are integers and must be equal. The port keeps one int64 key per
window where the JAX package keeps one or two uint32 words; ``_jax_keys``
maps the words to the port's layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamem_tpu.config import Config as JaxConfig
from slamem_tpu.config import MatchMode as JaxMode
from slamem_tpu.engine import seed_mode as jseed
from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.io import str_to_codes
from slamem_tpu.utils.synth import mutate, random_genome, with_n_runs

from slamem_tpu_torch.config import Config, MatchMode
from slamem_tpu_torch.engine import scan_mode, seed_mode
from slamem_tpu_torch.index.serialize import index_from_numpy

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

_FIELDS = ("text", "sa", "bwt", "occ_ckpt", "counts")


def _port_index(jidx):
    return index_from_numpy({f: np.asarray(getattr(jidx, f))
                             for f in _FIELDS}, jidx.occ_block, "cpu")


def _jax_keys(words, k):
    """JAX uint32 key words -> the port's int64 keys."""
    w = [np.asarray(x).astype(np.uint64) for x in words]
    if k <= 16:
        key = w[0]
    elif k < 32:
        key = w[0] * np.uint64(4 ** (k - 16)) + w[1]
    else:
        key = ((w[0] << np.uint64(32)) | w[1]) ^ np.uint64(1 << 63)
    return key.view(np.int64)


def _tuples(m):
    return sorted(zip(m.refpos.tolist(), m.qpos.tolist(), m.length.tolist()))


def _with_separators(codes, at):
    out = codes.copy()
    out[list(at)] = 5
    return out


# one reference (N runs, separators) and a diverged query shared by the
# stage tests; the JAX index is built once
@pytest.fixture(scope="module")
def pair():
    ref = _with_separators(
        with_n_runs(random_genome(6000, seed=401), 3, 40, seed=402),
        (1500, 1501, 4200))
    qry = with_n_runs(mutate(ref % 4, 0.02, 0.002, seed=403), 2, 25,
                      seed=404)[:3000]
    jidx = jax_build(ref)
    return ref, jseed.pad_query(qry), jidx, _port_index(jidx)


@pytest.mark.parametrize("stride", [1, 3, 8])
@pytest.mark.parametrize("k", [5, 16, 17, 24, 32])
def test_packed_key_words_equal_jax(k, stride):
    text = _with_separators(
        with_n_runs(random_genome(700, seed=410 + k), 3, 6, seed=411),
        (100, 401))
    text[-3:] = [3, 3, 3]      # all-T windows: the largest keys at K = 32
    words, valid = jseed.packed_key_words(jnp.asarray(text), k, stride)
    keys, ok = seed_mode.packed_key_words(torch.from_numpy(text), k, stride)
    assert keys.dtype == torch.int64 and keys.shape == (-(-700 // stride),)
    assert np.array_equal(_jax_keys(words, k), keys.numpy())
    assert np.array_equal(np.asarray(valid), ok.numpy())
    assert 0 < int(ok.sum()) < ok.numel()


@pytest.mark.parametrize("k", [8, 13, 16, 17, 24, 32])
def test_seed_table_equal_jax(pair, k):
    _, _, jidx, tidx = pair
    jrefk, jsa_aug = jseed.seed_table(jidx, k)
    refk, sa_aug = seed_mode.seed_table(tidx, k)
    assert np.array_equal(_jax_keys(jrefk, k), refk.numpy())
    assert np.array_equal(np.asarray(jsa_aug), sa_aug.numpy())
    assert bool((refk[1:] >= refk[:-1]).all())          # sorted in SA order
    assert seed_mode.seed_table(tidx, k)[0] is refk      # cached per index


@pytest.mark.parametrize("k", [10, 14, 17, 24, 32])
def test_bucket_table_equal_jax(pair, k):
    """k = 10: direct table (bbits = 2K, no probes); 14: single word with a
    shift; 17, 24, 32: two-word keys, word 0 prefixes, refined."""
    _, _, jidx, tidx = pair
    jstarts, jshift, jprobes = jseed.bucket_table(jidx, k)
    starts, shift, probes = seed_mode.bucket_table(tidx, k)
    assert (shift, probes) == (jshift, jprobes)
    assert (probes == 0) == (k == 10)
    assert starts.dtype == torch.int32
    assert np.array_equal(np.asarray(jstarts), starts.numpy())


@pytest.mark.parametrize("k,stride", [(10, 1), (14, 3), (24, 7), (32, 9)])
def test_intervals_equal_jax(pair, k, stride):
    """(lo, width) of the bucket, join and binary-search frontends: each
    equals its JAX counterpart exactly, and the three agree (lo wherever
    the width is non-zero)."""
    _, qp, jidx, tidx = pair
    jrefk, _ = jseed.seed_table(jidx, k)
    jqk, jqv = jseed.sampled_query_keys(jnp.asarray(qp), k, stride)
    jst, jsh, jpr = jseed.bucket_table(jidx, k)
    want = {"join": jseed._join_intervals(jrefk, jqk, jqv),
            "bucket": jseed._bucket_intervals(jrefk, jst, jqk, jqv, jsh,
                                              jpr),
            "search": jseed.seed_intervals(jrefk, jqk, jqv)}
    refk, _ = seed_mode.seed_table(tidx, k)
    qk, qv = seed_mode.packed_key_words(torch.from_numpy(qp), k, stride)
    st, sh, pr = seed_mode.bucket_table(tidx, k)
    got = {"join": seed_mode._join_intervals(refk, qk, qv),
           "bucket": seed_mode._bucket_intervals(refk, st, qk, qv, sh, pr, k),
           "search": seed_mode.seed_intervals(refk, qk, qv)}
    for name, (lo, w) in got.items():
        assert lo.dtype == w.dtype == torch.int32, name
        assert np.array_equal(np.asarray(want[name][0]), lo.numpy()), name
        assert np.array_equal(np.asarray(want[name][1]), w.numpy()), name
    w0 = got["join"][1].numpy()
    assert int((w0 > 0).sum()) > len(w0) // 4
    for name in ("bucket", "search"):
        assert np.array_equal(got[name][1].numpy(), w0)
        assert np.array_equal(got[name][0].numpy()[w0 > 0],
                              got["join"][0].numpy()[w0 > 0])


def test_ext_arrays_equal_jax(pair):
    ref, qp, _, _ = pair
    for text in (ref, qp, np.array([5], np.uint8)):
        want = jseed.ext_arrays(jnp.asarray(text))
        got = seed_mode.ext_arrays(torch.from_numpy(text))
        for name, a, b in zip(("fx", "fxl", "lvl", "lvr"), want, got):
            assert np.array_equal(np.asarray(a).astype(np.int64),
                                  b.numpy().astype(np.int64)), name
        assert got[2].dtype == got[3].dtype == torch.uint8


def test_digit_counts_equal_jax():
    rng = np.random.default_rng(420)
    x = np.concatenate([
        np.array([0, 1, 2, 3, 4, 12, 1 << 30, 3 << 30, (1 << 31) + 1,
                  (1 << 32) - 1, (1 << 32) - 4], np.uint64),
        rng.integers(0, 1 << 32, 2000, dtype=np.uint64),
        (np.uint64(1) << rng.integers(0, 32, 200).astype(np.uint64))])
    xj = jnp.asarray(x.astype(np.uint32))
    xt = torch.from_numpy(x.astype(np.int64))
    for jf, tf in ((jseed._ctz_digits, seed_mode._ctz_digits),
                   (jseed._clz_digits, seed_mode._clz_digits)):
        want = np.asarray(jf(xj)).astype(np.int64)
        assert np.array_equal(want, tf(xt).numpy())
        assert int(tf(xt[:1])) == 16


@pytest.mark.parametrize("k,stride", [(13, 8), (14, 14), (24, 7)])
def test_extend_core_equal_jax(pair, k, stride):
    """Extension bounds of random sample-space run triples (in range, at
    the edges and beyond them, where the clamps act)."""
    ref, qp, _, _ = pair
    rng = np.random.default_rng(430 + k)
    nr = 3000
    m_s = -(-len(qp) // stride)
    qs_s = rng.integers(-1, m_s + 1, nr)
    qe_s = qs_s + rng.integers(0, 6, nr)
    diag = rng.integers(-len(qp), len(ref) + 1, nr)
    ext_rj = jseed.ext_arrays(jnp.asarray(ref))
    ext_qj = jseed.ext_arrays(jnp.asarray(qp))
    wqs, wqe = jseed.extend_runs(
        jnp.asarray(diag, jnp.int32), jnp.asarray(qs_s, jnp.int32),
        jnp.asarray(qe_s, jnp.int32), jnp.int32(nr), ext_rj, ext_qj,
        stride, k)
    ext_r = seed_mode.ext_arrays(torch.from_numpy(ref))
    ext_q = seed_mode.ext_arrays(torch.from_numpy(qp))
    gqs, gqe = seed_mode._extend_core(
        torch.from_numpy(diag), torch.from_numpy(qs_s),
        torch.from_numpy(qe_s), ext_r, ext_q, stride, k)
    assert np.array_equal(np.asarray(wqs), gqs.numpy())
    assert np.array_equal(np.asarray(wqe), gqe.numpy())


def test_strided_pair_runs_equal_jax(pair):
    """Expansion + pair sort + run compaction of one block at stride 8 ==
    JAX's fixed-capacity expand_block_to_runs (its first n_runs rows)."""
    _, qp, jidx, tidx = pair
    k, stride = 13, 8
    jrefk, jsa_aug = jseed.seed_table(jidx, k)
    jqk, jqv = jseed.sampled_query_keys(jnp.asarray(qp), k, stride)
    lo_j, w_j = jseed._join_intervals(jrefk, jqk, jqv)
    m_s = int(lo_j.shape[0])
    start, end, block = 40, 300, m_s
    m_off = ((m_s + block + 2) * stride + 2) // 2
    pad = jnp.zeros((block,), jnp.int32)
    jd, jqs, jqe, jn, _ = jseed.expand_block_to_runs(
        jsa_aug, jnp.concatenate([lo_j, pad]), jnp.concatenate([w_j, pad]),
        jnp.asarray(start, jnp.int64), jnp.asarray(end, jnp.int64),
        jnp.asarray(m_off, jnp.int32), 1 << 14, 4096, block, stride)
    _, sa_aug = seed_mode.seed_table(tidx, k)
    td, tqs, tqe = seed_mode.expand_block_to_runs(
        sa_aug, torch.from_numpy(np.array(lo_j)),
        torch.from_numpy(np.array(w_j)), start, end, m_off, stride)
    nr = int(jn)
    assert nr == td.shape[0] > 0
    for a, b in ((jd, td), (jqs, tqs), (jqe, tqe)):
        assert np.array_equal(np.asarray(a)[:nr], b.numpy())


_GRID_N = (1000, 6000, 5_000_000, 40_000_000, 250_000_000, 3_000_000_000)
_GRID_M = (1024, 5_000_000, 50_000_000)
_GRID_L = (2, 8, 12, 20, 22, 23, 30, 40, 50, 100)
_GRID_CAP = (8, 12, 13, 14, 16, 24, 32)


def test_plan_functions_equal_jax():
    for n in _GRID_N:
        for m in _GRID_M:
            for L in _GRID_L:
                for cap in _GRID_CAP:
                    args = (n, m, L, cap)
                    assert (seed_mode.choose_seed_k(*args)
                            == jseed.choose_seed_k(*args)), args
                    assert (seed_mode.choose_seed_k_sparse(*args)
                            == jseed.choose_seed_k_sparse(*args)), args
                    for sparse in ("auto", "off"):
                        assert (seed_mode.choose_seed_plan(n, m, Config(
                            min_length=L, seed_length_cap=cap,
                            sparse_seeds=sparse))
                            == jseed.choose_seed_plan(n, m, JaxConfig(
                                min_length=L, seed_length_cap=cap,
                                sparse_seeds=sparse))), (args, sparse)
    for k in range(1, 33):
        for L in range(k, 70):
            s = seed_mode.choose_stride(k, L)
            assert s == jseed.choose_stride(k, L)
            assert seed_mode.span_w_min(L, k, s) == jseed.span_w_min(L, k, s)
    for n in _GRID_N:
        for m in _GRID_M:
            for words in (1, 2):
                for probes in (None, 0, 3, 5, 12):
                    assert (seed_mode.prefer_bucket(n, m, words, probes)
                            == jseed.prefer_bucket(n, m, words, probes))
                    for bucket in (False, True):
                        for stride in (1, 8, 14):
                            a = (n, m, words, 123_457, bucket, stride,
                                 probes or 0)
                            assert (seed_mode.roofline_bytes(*a)
                                    == jseed.roofline_bytes(*a))


@pytest.mark.parametrize("L,frontend", [(12, "auto"), (20, "auto"),
                                        (50, "auto"), (20, "join"),
                                        (20, "bucket"), (30, "auto")])
def test_plan_fused_equal_jax(pair, L, frontend):
    _, qp, jidx, tidx = pair
    m_p = len(qp)
    jplan = jseed.plan_fused(jidx, m_p, JaxConfig(min_length=L,
                                                  frontend=frontend))
    assert seed_mode.plan_fused(tidx, m_p, Config(
        min_length=L, frontend=frontend)) == (jplan.k, jplan.stride,
                                              jplan.use_bucket)


def _low_complexity():
    ref = np.concatenate([np.zeros(60, np.uint8), str_to_codes("ACGT" * 30),
                          random_genome(500, seed=13)])
    qry = np.concatenate([np.zeros(40, np.uint8), str_to_codes("ACGT" * 20),
                          mutate(random_genome(500, seed=13), 0.02, 0,
                                 seed=14)])
    return ref, qry


def _strain(n=6000, seed=440, sub=0.01, indel=0.001, n_runs=0):
    ref = random_genome(n, seed=seed)
    qry = mutate(ref, sub, indel, seed=seed + 1)
    if n_runs:
        ref = with_n_runs(ref, n_runs, 30, seed=seed + 2)
        qry = with_n_runs(qry, n_runs, 20, seed=seed + 3)
    return ref, qry


def _repeats():
    ref = random_genome(3000, seed=450)
    ref[1000:1100] = ref[200:300]
    ref[2000:2100] = ref[200:300]
    qry = mutate(ref, 0.01, 0.001, seed=451)
    return ref, np.concatenate([qry, qry[240:320]])


# name -> (inputs, config fields, two-word K forced?)
SEED_CASES = {
    "sparse_l20": (_strain, dict(min_length=20), False),
    "dense_l14": (_strain, dict(min_length=14, sparse_seeds="off"), False),
    "deep_l50_span_filter": (lambda: _strain(sub=0.004, indel=0.0004),
                             dict(min_length=50), False),
    "two_word_k24": (_strain, dict(min_length=30), True),
    "two_word_k32": (lambda: _strain(sub=0.006, indel=0.0006),
                     dict(min_length=40), True),
    "multi_round": (_strain, dict(min_length=20, pair_capacity=64,
                                  position_block=37), False),
    "n_runs_bucket": (lambda: _strain(n_runs=4),
                      dict(min_length=12, frontend="bucket"), False),
    "n_runs_join": (lambda: _strain(n_runs=4),
                    dict(min_length=16, frontend="join"), False),
    "low_complexity": (_low_complexity,
                       dict(min_length=10, pair_capacity=1 << 14), False),
    "edges": (lambda: (str_to_codes("ACGTACGTAAGGCA"),
                       str_to_codes("ACGTACGTAAGGCA")),
              dict(min_length=10), False),
    "mam": (_repeats, dict(min_length=14, mode="mam"), False),
    "mum": (_repeats, dict(min_length=14, mode="mum"), False),
}


@pytest.mark.parametrize("case", sorted(SEED_CASES))
def test_find_seed_matches_equal_jax(case, monkeypatch):
    make, fields, two_word = SEED_CASES[case]
    ref, qry = make()
    if two_word:   # K = min(L - 6, cap) even at this size: two JAX words
        deep = lambda n, m, L, cap: min(L - 6, cap)  # noqa: E731
        monkeypatch.setattr(jseed, "choose_seed_k_sparse", deep)
        monkeypatch.setattr(seed_mode, "choose_seed_k_sparse", deep)
    fields = dict(fields)
    mode = fields.pop("mode", "mem")
    jcfg = JaxConfig(mode=JaxMode(mode), **fields)
    tcfg = Config(mode=MatchMode(mode), **fields)
    jidx = jax_build(ref)
    want = jseed.find_seed_matches(jidx, qry, jcfg)
    got = seed_mode.find_seed_matches(_port_index(jidx), qry, tcfg)
    assert _tuples(got) == _tuples(want) and len(want.length) > 0
    for f in ("pairs", "k", "stride", "bytes_min"):
        assert got.stats[f] == want.stats[f], f
    assert _tuples(seed_mode.apply_mode_filter(got, tcfg)) == _tuples(
        jseed.apply_mode_filter(want, jcfg))
    k, stride = got.stats["k"], got.stats["stride"]
    if case == "deep_l50_span_filter":
        assert seed_mode.span_w_min(50, k, stride) >= 2
    if two_word:
        assert k > 16 and stride > 1
    if case == "multi_round":
        assert got.stats["rounds"] > 1
    assert set(got.stats["stage_s"]) >= {"upload", "tables", "frontend",
                                         "expand", "merge"}


@pytest.mark.parametrize("L,mode", [(9, "mem"), (40, "mem"), (12, "mum")])
def test_seed_equals_scan(L, mode):
    """Both engines of the port give identical matches (the JAX package's
    test_scan_equals_seed, on the port alone)."""
    ref = random_genome(2500, seed=68)
    qry = mutate(ref, 0.015, 0.0015, seed=69)
    tidx = _port_index(jax_build(ref))
    a_cfg = Config(min_length=L, mode=MatchMode(mode))
    b_cfg = Config(min_length=L, mode=MatchMode(mode), engine="scan")
    a = seed_mode.apply_mode_filter(
        seed_mode.find_seed_matches(tidx, qry, a_cfg), a_cfg)
    b = seed_mode.apply_mode_filter(
        scan_mode.find_scan_matches(tidx, qry, b_cfg), b_cfg)
    assert _tuples(a) == _tuples(b) and len(a.length) > 0


# ---------------------------------------------------------------------------
# The boundary backend (Config.match_backend = "boundary")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,end", [(0, 4096), (700, 2100)])
def test_expand_flags_core_equal_jax(pair, start, end):
    """Start / end events of one block == JAX's expand_block_to_boundaries
    run at capacities sized to the data (its first n_starts / n_ends rows,
    in expansion order)."""
    _, qp, jidx, tidx = pair
    k = 12
    jrefk, jsa_aug = jseed.seed_table(jidx, k)
    jqk, jqv = jseed.sampled_query_keys(jnp.asarray(qp), k, 1)
    lo_j, w_j = jseed._join_intervals(jrefk, jqk, jqv)
    m = int(lo_j.shape[0])
    block = m
    m_off = (m + block + 2) // 2
    npairs = int(np.asarray(w_j)[start:end].sum())
    pad = jnp.zeros((block,), jnp.int32)
    sd, sq, ed, eq, ns, ne, _ = jseed.expand_block_to_boundaries(
        jidx.text, jnp.asarray(qp), jsa_aug, jnp.concatenate([lo_j, pad]),
        jnp.concatenate([w_j, pad]), jnp.asarray(start, jnp.int64),
        jnp.asarray(end, jnp.int64), jnp.asarray(m_off, jnp.int32), k,
        npairs + 1, npairs + 1, block)
    _, sa_aug = seed_mode.seed_table(tidx, k)
    got = seed_mode.expand_block_to_boundaries(
        tidx.text, torch.from_numpy(qp), sa_aug,
        torch.from_numpy(np.array(lo_j)), torch.from_numpy(np.array(w_j)),
        start, end, m_off, k)
    ns, ne = int(ns), int(ne)
    assert 0 < ns == got[0].shape[0] and 0 < ne == got[2].shape[0]
    if (start, end) == (0, m):      # whole runs: one end per start
        assert ns == ne
    for a, b, cnt in ((sd, got[0], ns), (sq, got[1], ns), (ed, got[2], ne),
                      (eq, got[3], ne)):
        assert b.dtype == torch.int32
        assert np.array_equal(np.asarray(a)[:cnt], b.numpy())


BOUNDARY_CASES = {
    "one_round": (_strain, dict(min_length=14)),
    "many_rounds": (_strain, dict(min_length=14, pair_capacity=64,
                                  position_block=37)),
    "n_runs_separators": (lambda: (_with_separators(
        with_n_runs(random_genome(5000, seed=460), 3, 30, seed=461),
        (900, 2500)), with_n_runs(mutate(random_genome(5000, seed=460),
                                         0.01, 0.001, seed=462), 2, 20,
                                  seed=463)), dict(min_length=12)),
    "low_complexity": (_low_complexity, dict(min_length=10,
                                             pair_capacity=1 << 14)),
    "mum": (_repeats, dict(min_length=14, mode="mum", pair_capacity=256)),
    "mam": (_repeats, dict(min_length=14, mode="mam")),
}


@pytest.mark.parametrize("case", sorted(BOUNDARY_CASES))
def test_boundary_backend_equal_jax_and_sort(case):
    """find_seed_matches with match_backend="boundary" == the JAX package's
    boundary result == the port's sort result (dense, stride 1)."""
    make, fields = BOUNDARY_CASES[case]
    ref, qry = make()
    fields = dict(fields)
    mode = fields.pop("mode", "mem")
    jcfg = JaxConfig(mode=JaxMode(mode), match_backend="boundary", **fields)
    tcfg = Config(mode=MatchMode(mode), match_backend="boundary", **fields)
    jidx = jax_build(ref)
    tidx = _port_index(jidx)
    want = jseed.find_seed_matches(jidx, qry, jcfg)
    got = seed_mode.find_seed_matches(tidx, qry, tcfg)
    sort = seed_mode.find_seed_matches(tidx, qry, Config(
        mode=MatchMode(mode), sparse_seeds="off", **fields))
    assert _tuples(got) == _tuples(want) == _tuples(sort)
    assert len(want.length) > 0
    assert got.stats["stride"] == 1 and got.stats["k"] == want.stats["k"]
    assert got.stats["pairs"] == want.stats["pairs"] == sort.stats["pairs"]
    if case == "many_rounds":
        assert got.stats["rounds"] > 1
    assert _tuples(seed_mode.apply_mode_filter(got, tcfg)) == _tuples(
        jseed.apply_mode_filter(want, jcfg))


@pytest.mark.parametrize("engine", ["seed", "scan"])
@pytest.mark.parametrize("mode", ["mem", "mum", "mam"])
def test_run_engine_boundary_listing_equal_jax(engine, mode):
    """run_engine with -b over a multi-FASTA pair: the boundary backend's
    listing bytes == the JAX package's boundary listing == the port's sort
    listing, one round and many."""
    from slamem_tpu.engine.run import run_engine as jax_run
    from slamem_tpu.io.fasta import FastaSet as JaxFastaSet
    from slamem_tpu.report.format import format_matches as jax_format

    from slamem_tpu_torch.engine.run import run_engine
    from slamem_tpu_torch.io.fasta import FastaSet
    from slamem_tpu_torch.report.format import format_matches

    base = with_n_runs(random_genome(3000, seed=470), 3, 20, seed=471)
    base[2200:2500] = base[300:600]
    qry = with_n_runs(mutate(base, 0.015, 0.0015, seed=472), 2, 15,
                      seed=473)
    refs = (["chrA", "chrB"], [base[:1800], base[1800:]])
    qrys = (["r1", "r2"], [qry[100:1500], qry[1700:2900]])

    def sets(cls, names, parts):
        lengths = np.array([len(p) for p in parts], np.int64)
        return cls(names=list(names), starts=np.cumsum(lengths) - lengths,
                   lengths=lengths, codes=np.concatenate(parts))

    fields = dict(min_length=14, both_strands=True, engine=engine)
    want = jax_format(jax_run(sets(JaxFastaSet, *refs),
                              sets(JaxFastaSet, *qrys),
                              JaxConfig(mode=JaxMode(mode),
                                        match_backend="boundary", **fields)))
    ref_set, qry_set = sets(FastaSet, *refs), sets(FastaSet, *qrys)
    listings = [format_matches(run_engine(ref_set, qry_set, Config(
        mode=MatchMode(mode), **fields, **extra), device="cpu"))
        for extra in (dict(match_backend="boundary"),
                      dict(match_backend="boundary", pair_capacity=128),
                      {})]
    assert all(lst == want for lst in listings)
    assert want.count("\n") > 8

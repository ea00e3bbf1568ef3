"""Port vs JAX package: the seed engine's device tail, on the CPU.

* ``extend_runs`` (its CPU route, ``_extend_core`` over ``ext_arrays``)
  against the JAX package's ``extend_runs`` over its ``ext_arrays``;
* a numpy model of the CUDA kernel's per-run arithmetic
  (``kernels/csrc/extend.cu``: each 16-byte window from the aligned 32
  bytes around it, by a word select and a funnel shift, or byte by byte
  with out-of-range bytes as N within 32 bytes of a text's end; the
  per-lane equal-and-ordinary byte mask, the 16-bit run mask, its leading
  / trailing one counts) against the same JAX outputs, since the kernel
  itself runs only on a card (tests/test_torch_cuda.py);
* ``merge_runs_device`` against the JAX package's ``merge_runs`` plus the
  span filter, on the run fragments of several rounds.

Triples: real merged runs, random ones, ones placed at both text edges,
beyond them (the clamps) and beside N runs and separators, and windows at
every distance 0..33 from both ends of both texts; the texts also at every
base-address residue 0..15. Tolerance: exact — every value is an integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamem_tpu.engine import seed_mode as jseed
from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.utils.synth import mutate, random_genome, with_n_runs

from slamem_tpu_torch.engine import seed_mode

torch.set_num_threads(1)

_CASES = [(13, 8), (14, 14), (24, 7)]   # (k, stride)
_BLOCK = 16                              # samples per round
_CAP = 1 << 14                           # pairs per round
_RUN_CAP = 4096                          # runs per round


@pytest.fixture(scope="module")
def texts():
    """A reference with N runs, a repeat and separators and a query strain
    of it with N runs, padded with N as the engine pads it; the JAX index."""
    ref = with_n_runs(random_genome(6000, seed=801), 3, 40, seed=802)
    ref[3000:3400] = ref[600:1000]         # a repeat: a second diagonal
    ref[[1500, 1501, 4200]] = 5
    qry = with_n_runs(mutate(ref % 4, 0.01, 0.001, seed=803), 2, 25,
                      seed=804)[:3000]
    return ref, jseed.pad_query(qry), jax_build(ref)


def _round_fragments(texts, k, stride, block=_BLOCK):
    """The JAX package's run fragments of each round of ``block`` query
    samples (expand_block_to_runs: expansion, pair sort, compaction), as
    (d', qstart, qend) int64 numpy columns per round, and m_off."""
    _, qp, jidx = texts
    jrefk, jsa_aug = jseed.seed_table(jidx, k)
    jqk, jqv = jseed.sampled_query_keys(jnp.asarray(qp), k, stride)
    lo, w = jseed._join_intervals(jrefk, jqk, jqv)
    m_s = int(lo.shape[0])
    m_off = (((m_s + block + 2) * stride + 2) // 2 if stride > 1
             else (m_s + block + 2) // 2)
    pad = jnp.zeros((block,), jnp.int32)
    lo, w = jnp.concatenate([lo, pad]), jnp.concatenate([w, pad])
    rounds = []
    for start in range(0, m_s, block):
        d, qs, qe, n, _ = jseed.expand_block_to_runs(
            jsa_aug, lo, w, jnp.asarray(start, jnp.int64),
            jnp.asarray(min(start + block, m_s), jnp.int64),
            jnp.asarray(m_off, jnp.int32), _CAP, _RUN_CAP, block, stride)
        n = int(n)
        assert n <= _RUN_CAP
        rounds.append(np.stack([np.asarray(x)[:n].astype(np.int64)
                                for x in (d, qs, qe)], 1))
    return rounds, m_off


def _jax_merged(rounds, m_off, w_min):
    """JAX merge_runs over the rounds, then the span filter: (diag, qstart,
    qend) int64, diag true."""
    runs = jseed.merge_runs([jseed.RunBatch(r[:, 0] - m_off, r[:, 1],
                                            r[:, 2]) for r in rounds])
    keep = runs.qend - runs.qstart + 1 >= w_min
    return runs.diag[keep], runs.qstart[keep], runs.qend[keep]


def _triples(texts, k, stride):
    """int64 (diag, qs_s, qe_s): the merged real runs, random triples, and
    triples at the text edges, beyond them and beside specials."""
    ref, qp, _ = texts
    n, m = len(ref), len(qp)
    m_s = -(-m // stride)
    rng = np.random.default_rng(810 + k)
    rounds, m_off = _round_fragments(texts, k, stride)
    real = _jax_merged(rounds, m_off, 1)
    nr = 2000
    qs = rng.integers(-1, m_s + 2, nr)
    rand = (rng.integers(-m, n + 1, nr), qs, qs + rng.integers(0, 6, nr))
    edge_q = np.array([-2, -1, 0, 1, m_s - 2, m_s - 1, m_s, m_s + 1])
    eq_s = np.repeat(edge_q, 8)
    ed = np.concatenate([[-m - 5, -e * stride, -e * stride - 1,
                          n - e * stride - k, n - e * stride, n - 3,
                          n, n + 20] for e in edge_q])
    edge = (ed, eq_s, eq_s + np.tile([0, 1, 3, 0], 16))
    # boundaries within 3 of a special of either text (N runs, separators,
    # the query's N padding), from both sides
    spec_r = np.flatnonzero(ref >= 4)[::7]
    spec_q = np.flatnonzero(qp >= 4)[::11]
    s_qs = rng.integers(0, m_s, spec_r.size + spec_q.size)
    near = np.concatenate([spec_r - s_qs[:spec_r.size] * stride,
                           rng.integers(-m, n, spec_q.size)])
    s_qs[spec_r.size:] = spec_q // stride
    delta = rng.integers(-3, 4, near.size)
    spec = (near + delta, s_qs, s_qs + rng.integers(0, 3, near.size))
    parts = (real, rand, edge, spec)
    return tuple(np.concatenate([p[i] for p in parts]).astype(np.int64)
                 for i in range(3))


def _jax_extend(texts, trip, k, stride):
    ref, qp, _ = texts
    diag, qs, qe = (jnp.asarray(x, jnp.int32) for x in trip)
    got = jseed.extend_runs(diag, qs, qe, jnp.int32(diag.shape[0]),
                            jseed.ext_arrays(jnp.asarray(ref)),
                            jseed.ext_arrays(jnp.asarray(qp)), stride, k)
    return tuple(np.asarray(x).astype(np.int64) for x in got)


@pytest.mark.parametrize("k,stride", _CASES)
def test_extend_runs_cpu_equal_jax(texts, k, stride):
    """The CPU route of extend_runs, with and without the reference's
    cached tables, == the JAX package's extend_runs; no launch counted."""
    ref, qp, _ = texts
    trip = _triples(texts, k, stride)
    want = _jax_extend(texts, trip, k, stride)
    args = [torch.from_numpy(x) for x in trip]
    ref_t, q_t = torch.from_numpy(ref), torch.from_numpy(qp)
    before = seed_mode.extend_runs.launches
    for ext_r in (None, seed_mode.ext_arrays(ref_t)):
        got = seed_mode.extend_runs(*args, ref_t, q_t, stride, k, ext_r)
        for g, w in zip(got, want):
            assert g.dtype == torch.int64
            assert np.array_equal(g.numpy(), w)
    assert seed_mode.extend_runs.launches == before
    # the real runs extended, some by the full stride - 1
    ext = (trip[1] * stride - want[0]) + (want[1] - trip[2] * stride)
    assert int(ext.max()) >= stride - 1 and int((ext > 0).sum()) > 20


def test_extend_runs_checks_arguments(texts):
    ref, qp, _ = texts
    runs = [torch.zeros(4, dtype=torch.int64) for _ in range(3)]
    ref_t, q_t = torch.from_numpy(ref), torch.from_numpy(qp)
    with pytest.raises(ValueError, match="int64"):
        seed_mode.extend_runs(runs[0].to(torch.int32), *runs[1:], ref_t,
                              q_t, 8, 13)
    with pytest.raises(ValueError, match="uint8"):
        seed_mode.extend_runs(*runs, ref_t.to(torch.int32), q_t, 8, 13)
    with pytest.raises(ValueError, match="shape"):
        seed_mode.extend_runs(runs[0][:3], *runs[1:], ref_t, q_t, 8, 13)


# ---------------------------------------------------------------------------
# A numpy model of csrc/extend.cu, step for step
# ---------------------------------------------------------------------------

_BYTE_SHIFTS = np.array([0, 8, 16, 24], np.uint32)


def _words(b):
    """(..., 4 w) uint8 -> (..., w) little-endian uint32 words."""
    b = b.astype(np.uint32).reshape(*b.shape[:-1], -1, 4) << _BYTE_SHIFTS
    return np.bitwise_or.reduce(b, axis=-1)


def _bytewise_lanes(text, start):
    """(nr, 4) uint32 lanes of bytes [start, start + 16), little-endian,
    a byte outside the text read as N (the slow path, window_lane)."""
    pos = start[:, None] + np.arange(16)
    ok = (pos >= 0) & (pos < text.size)
    return _words(np.where(ok, text[np.clip(pos, 0, text.size - 1)], 4))


def _window_lanes(text, start):
    """The same lanes as load_window + window_lanes read them: where the
    aligned span [lo, lo + 32), lo = start - (address of text[start]) %
    16, lies inside the text, its eight words, a select of whole words and
    a funnel shift; elsewhere bytewise. Also returns which windows took
    the fast path."""
    off = (text.ctypes.data + start) & 15
    lo = start - off
    fast = (lo >= 0) & (lo + 32 <= text.size)
    pos = np.where(fast, lo, 0)[:, None] + np.arange(32)
    c = _words(text[np.clip(pos, 0, text.size - 1)])        # (nr, 8)
    s = np.take_along_axis(c, (off >> 2)[:, None] + np.arange(5), axis=1)
    sh = (8 * (off & 3)).astype(np.uint64)[:, None]
    pair = s[:, :4].astype(np.uint64) | (s[:, 1:].astype(np.uint64) << 32)
    x = ((pair >> sh) & 0xFFFFFFFF).astype(np.uint32)     # __funnelshift_r
    return np.where(fast[:, None], x, _bytewise_lanes(text, start)), fast


def _per_byte(x, y, op):
    """0xFF in each byte where op(byte of x, byte of y) (__vcmp*4)."""
    out = np.zeros_like(x)
    for sh in _BYTE_SHIFTS:
        hit = op((x >> sh) & 0xFF, (y >> sh) & 0xFF)
        out |= np.where(hit, np.uint32(0xFF) << sh, np.uint32(0))
    return out


def _match_mask(x, y):
    """16-bit mask, bit j: window byte j equal and ordinary in both."""
    hit = (_per_byte(x, y, np.equal)
           & _per_byte(x, np.full_like(x, 0x04040404), np.less))
    bits = (((hit >> 7) & 1) | ((hit >> 14) & 2) | ((hit >> 21) & 4)
            | ((hit >> 28) & 8))
    return np.bitwise_or.reduce(bits << np.array([0, 4, 8, 12], np.uint32),
                                axis=1)


def _bit_length(x):
    out = np.zeros(x.shape, np.int64)
    for b in range(32):
        out = np.where((x >> np.uint32(b)) & 1, b + 1, out)
    return out


def _kernel_model(diag, qs_s, qe_s, ref, qry, stride, k):
    """(qstart', qend') as the kernel computes them, and the (nr, 4)
    fast-path flags of the windows (left query, left reference, right
    query, right reference)."""
    n, m = ref.size, qry.size
    qs = qs_s * stride
    qe_core = qe_s * stride
    qe_b = qe_core + k
    rs, rb = np.clip(qs + diag, 0, n), np.clip(qe_b + diag, 0, n)
    qsc, qbc = np.clip(qs, 0, m), np.clip(qe_b, 0, m)
    wins = [_window_lanes(qry, qsc - 16), _window_lanes(ref, rs - 16),
            _window_lanes(qry, qbc), _window_lanes(ref, rb)]
    left = _match_mask(wins[0][0], wins[1][0])
    right = _match_mask(wins[2][0], wins[3][0])
    clz = 32 - _bit_length(~(left << np.uint32(16)))        # __clz
    inv = ~right
    ffs = _bit_length(inv & (~inv + np.uint32(1)))          # __ffs
    return qs - clz, qe_core + (ffs - 1), np.stack([w[1] for w in wins], 1)


@pytest.mark.parametrize("k,stride", _CASES)
def test_kernel_window_model_equal_jax(texts, k, stride):
    """The kernel's arithmetic, modelled in numpy on the same triples, ==
    the JAX package's extend_runs."""
    ref, qp, _ = texts
    trip = _triples(texts, k, stride)
    want = _jax_extend(texts, trip, k, stride)
    got = _kernel_model(*trip, ref, qp, stride, k)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert 0.5 < got[2].mean() < 1       # both paths, mostly the fast one


def _window_triples(n, m, stride, k):
    """int64 (diag, qs_s, qe_s) whose windows lie at every distance d =
    0..33 from both ends of both texts: for each d, side and end, one
    triple puts that side's reference window and (exactly at stride 1, at
    the sample position at or below it otherwise) its query window d bytes
    from that end, and one more pairs the query's end with the
    reference's other end."""
    d = np.arange(34)
    q_l = np.concatenate([d + 16, m - d])      # left boundaries: start, end
    r_l = np.concatenate([d + 16, n - d])
    q_r = np.concatenate([d, m - 16 - d])      # right boundaries
    r_r = np.concatenate([d, n - 16 - d])
    qs_l = q_l // stride
    qe_r = (q_r - k) // stride
    diag = np.concatenate([r_l - qs_l * stride, r_l[::-1] - qs_l * stride,
                           r_r - (qe_r * stride + k),
                           r_r[::-1] - (qe_r * stride + k)])
    qs = np.concatenate([qs_l, qs_l, qe_r - 1, qe_r - 1])
    qe = np.concatenate([qs_l + 1, qs_l + 1, qe_r, qe_r])
    return diag, qs, qe


def _at_offset(text, r):
    """text copied into a larger array, as a view whose address is r
    modulo 16."""
    big = np.full(text.size + 48, 7, np.uint8)
    a = -big.ctypes.data % 16 + r
    big[a:a + text.size] = text
    return big[a:a + text.size]


@pytest.mark.parametrize("r", range(16))
def test_kernel_model_alignment_equal_jax(texts, r):
    """The model with both texts at base-address residue r (the reference
    at residue 3 r % 16, so the two differ) == the JAX package's
    extend_runs, on the real, random, edge and window triples; both paths
    taken."""
    ref, qp, _ = texts
    k, stride = _CASES[0]
    trip = tuple(np.concatenate(p) for p in zip(
        _triples(texts, k, stride), _window_triples(len(ref), len(qp),
                                                    stride, k)))
    want = _jax_extend(texts, trip, k, stride)
    got = _kernel_model(*trip, _at_offset(ref, 3 * r % 16),
                        _at_offset(qp, r), stride, k)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("k,stride", [(13, 1), (24, 1), (14, 14)])
def test_kernel_model_edges_equal_jax(texts, k, stride):
    """Windows at every distance 0..33 from both ends of both texts, with
    the texts at every base-address residue: the model == the JAX
    package's extend_runs; the windows within 32 bytes of an end take the
    slow path."""
    ref, qp, _ = texts
    trip = _window_triples(len(ref), len(qp), stride, k)
    want = _jax_extend(texts, trip, k, stride)
    for r in range(16):
        got = _kernel_model(*trip, _at_offset(ref, r), _at_offset(qp, r),
                            stride, k)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        assert not got[2][:, 1].all() and got[2].any()


# ---------------------------------------------------------------------------
# The device merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,L", [(13, 8, 40), (14, 14, 50),
                                        (24, 7, 40), (12, 1, 20)])
def test_merge_runs_device_equal_jax(texts, k, stride, L):
    """merge_runs_device over every round's fragments, concatenated in a
    shuffled order, == JAX merge_runs + the span filter (span_w_min; at
    stride 1 the length filter L - k + 1), and == the port's host
    merge_runs; with w_min 1 too."""
    rounds, m_off = _round_fragments(texts, k, stride)
    frags = np.concatenate(rounds)
    assert len(rounds) > 1 and frags.shape[0] > 40
    perm = np.random.default_rng(820 + k).permutation(frags.shape[0])
    cols = [torch.from_numpy(frags[perm, i].astype(np.int32))
            for i in range(3)]
    w_span = (seed_mode.span_w_min(L, k, stride) if stride > 1
              else L - k + 1)
    assert w_span > 1
    host = seed_mode.merge_runs([seed_mode.RunBatch(r[:, 0] - m_off,
                                                    r[:, 1], r[:, 2])
                                 for r in rounds])
    for w_min in (1, w_span):
        want = _jax_merged(rounds, m_off, w_min)
        got = seed_mode.merge_runs_device(*cols, w_min)
        assert all(g.dtype == torch.int32 for g in got)
        got = (got[0].numpy() - m_off, got[1].numpy(), got[2].numpy())
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        if w_min == 1:   # chains formed across round edges
            assert len(want[0]) < frags.shape[0]
            for g, h in zip(got, (host.diag, host.qstart, host.qend)):
                assert np.array_equal(g, h)
        else:            # and short runs were dropped
            assert 0 < len(want[0]) < len(host.diag)

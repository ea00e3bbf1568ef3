"""Numpy models of the row counts of ``csrc/rank.cu`` against the JAX
package's rank functions, on the CPU.

Every kernel counts occ(c, j) from the nearer of two counters: a position
in the lower half of its row counts the symbols below it up from the row's
counter; one in the upper half counts the symbols at and above it down
from the next row's counter. In the table's last row the scan kernel
counts down from occ(c, n), which each warp counts once; the standalone
kernels count up there.
``occ2_warp`` (the scan kernel) gives each position of a pair a half-warp,
reads only the 16-byte chunks that hold counted symbols, packs both
halves' counts into one 32-bit sum and swaps the halves' results.
``rank_rows_kernel`` (the standalone 128-word kernels) gives a warp 32
queries, loaded by lane, and counts two a step, a half-warp each, with its
own (c, j) from the owner lane, parking each count in the owner lane.
``rank_rows_nib_any_kernel`` (nibble rows of any other width) counts the
nearer side's whole words as a head of up to three words, a body of
16-byte int4s and a tail, at the table's real address, plus the partial
word under its mask, a half-warp a query up to 132 words, else a warp.
The models below follow those kernels lane by lane (chunk, load predicate,
``low_mask`` built as ``__funnelshift_lc`` clamps it, ``__vcmpeq4`` for K0,
the zero-nibble test for the nibble table, which lane loads which word)
and are held, over every position of the first, a middle and the last row
of a table built from a seeded random BWT with specials (N, SEP, the
sentinel and the pad), and every c, to the JAX package's
``rank_rows_xla`` / ``rank_rows_nib`` (on the CPU) and to the port's plain
versions. Tolerance: exact (integers).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamem_tpu.kernels.rank import _build_rows as jax_build_rows
from slamem_tpu.kernels.rank import _build_rows_nib as jax_build_rows_nib
from slamem_tpu.kernels.rank import rank_rows_nib as jax_rank_rows_nib
from slamem_tpu.kernels.rank import rank_rows_xla as jax_rank_rows_xla

from slamem_tpu_torch.kernels import rank

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
LANES = np.arange(32)
# layout -> (symbols a row, symbols a 16-byte chunk)
LAYOUTS = {"k0": (rank.SYMS_PER_ROW, 16), "nib": (rank.NIB_PER_ROW, 32)}


def popc(x):
    """Set bits of 32-bit values held in int64."""
    x = np.asarray(x, np.int64) & M32
    return np.unpackbits(x.astype("<u4").view(np.uint8).reshape(
        *x.shape, 4), axis=-1).sum(-1).astype(np.int64)


def low_mask(bits):
    """``low_mask``: the low ``bits`` bits set, bits clamped to [0, 32]
    (``__funnelshift_lc(~0u, 0u, max(bits, 0))``)."""
    return (np.int64(1) << np.clip(bits, 0, 32)) - 1


def vcmpeq4(a, b):
    """``__vcmpeq4``: 0xFF in each byte where the bytes of a and b are
    equal, else 0."""
    out = np.zeros(np.broadcast(a, b).shape, np.int64)
    for k in range(4):
        eq = ((a >> (8 * k)) & 0xFF) == ((b >> (8 * k)) & 0xFF)
        out |= np.where(eq, np.int64(0xFF) << (8 * k), 0)
    return out


def count_k0(words, c, below, flip):
    """``K0Layout::count``: symbols of each chunk (words (..., 4)) equal
    to c below ``below``, or at / above it where flip is all ones."""
    rep = c * 0x01010101
    marks = sum(popc(vcmpeq4(words[..., k], rep)
                     & (low_mask(8 * below - 32 * k) ^ flip))
                for k in range(4))
    return marks >> 3


def count_nib(words, c, below, flip):
    """``NibLayout::count``: the zero-nibble test under the nibble mask."""
    rep = c * 0x11111111
    cnt = 0
    for e in range(4):
        y = words[..., e] ^ rep
        t = y & 0x77777777
        nz = ~((t + 0x77777777) | y) & 0x88888888
        cnt = cnt + popc(nz & (low_mask(4 * below - 32 * e) ^ flip))
    return cnt


COUNT = {"k0": count_k0, "nib": count_nib}


def _chunk_words(rows, b, chunk):
    """The four uint32 words (as int64) of 16-byte chunk ``chunk`` of row
    b: (..., 4)."""
    u = rows.astype(np.int64) & M32
    return np.stack([u[b, 4 * chunk + k] for k in range(4)], axis=-1)


def last_row_totals(rows, layout):
    """``last_row_totals``: occ(c, n) for c = 0..3, the last row's counter
    plus the count of its whole row, one full-warp count a c."""
    per_row, per_chunk = LAYOUTS[layout]
    last = rows.shape[0] - 1
    v = _chunk_words(rows, np.full(32, last), LANES)            # (32, 4)
    return np.array([rows[last, c] + COUNT[layout](
        v[1:], np.int64(c), per_chunk, 0).sum() for c in range(4)])


def occ2_model(rows, layout, c, jlo, jhi, totals):
    """``occ2_warp`` lane by lane (``totals`` = ``last_row_totals``);
    returns (occ(c, jlo), occ(c, jhi)) as every lane ends with them
    (asserted equal across lanes)."""
    per_row, per_chunk = LAYOUTS[layout]
    last = rows.shape[0] - 1
    hi = LANES >> 4
    j = np.where(hi == 1, jhi[:, None], jlo[:, None])          # (Q, 32)
    c = np.broadcast_to(c[:, None], j.shape)
    b = j // per_row
    w = j - b * per_row
    down = w >= per_row // 2
    chunk = (LANES & 15) + np.where(down, 16, 1)
    below = w - (chunk - 1) * per_chunk
    need = np.where(down, below < per_chunk, below > 0)
    v = np.where(need[..., None], _chunk_words(rows, b, chunk), 0)
    nxt = b + down
    counter = np.where(nxt > last, totals[c],
                       rows[np.minimum(nxt, last), c]).astype(np.int64)
    share = COUNT[layout](v, c, below, np.where(down, M32, 0)) << (16 * hi)
    both = share.sum(1, keepdims=True) & M32                   # one redux
    part = np.where(hi == 1, both >> 16, both & 0xFFFF)
    mine = np.where(down, counter - part, counter + part)
    other = mine[:, LANES ^ 16]                                # shfl_xor 16
    lo = np.where(hi == 1, other, mine)
    hi_occ = np.where(hi == 1, mine, other)
    assert (lo == lo[:, :1]).all() and (hi_occ == hi_occ[:, :1]).all()
    assert (share >= 0).all() and (share.sum(1) < 2**32).all()
    return lo[:, 0], hi_occ[:, 0]


def _owner_gather(x, src):
    """``__shfl_sync(kFull, x, src)`` for each lane of each warp: x, src
    (W, 32)."""
    return np.take_along_axis(x, src, axis=1)


def _warps(c, j):
    """(c, j) of the queries in warps of 32 (W, 32), a lane past nq taking
    (0, 0), and the mask of live lanes."""
    nq = j.size
    nw = -(-nq // 32)
    live = np.arange(nw * 32) < nq
    pad = lambda x: np.concatenate([x, np.zeros(nw * 32 - nq, x.dtype)])
    return (pad(c.astype(np.int64)).reshape(nw, 32),
            pad(j.astype(np.int64)).reshape(nw, 32), live.reshape(nw, 32))


def rank_rows_model(rows, layout, c, j):
    """``rank_rows_kernel<Layout>`` lane by lane: lane i loads query q0 + i
    and its counter (the next row's when it counts down, never past the
    last row); step s gives half hi the query 16 hi + s, whose (b, w, c,
    down) it takes from that lane; half lane h loads chunk h + 1 (up) or
    h + 16 (down) if it holds counted symbols, and chunk h + 17 in the
    last row's upper half; one packed sum a step, parked in the owner
    lane."""
    per_row, per_chunk = LAYOUTS[layout]
    nrows = rows.shape[0]
    cq, jq, live = _warps(c, j)
    b = jq // per_row
    w = jq - b * per_row
    down = (w >= per_row // 2) & (b < nrows - 1)
    counter = rows[b + down, cq].astype(np.int64)
    hi, h = LANES >> 4, LANES & 15
    part = np.zeros_like(jq)
    for s in range(16):
        src = np.broadcast_to((LANES & 16) | s, jq.shape)
        bs, ws, cs, ds = (_owner_gather(x, src) for x in (b, w, cq, down))
        chunk = h + np.where(ds, 16, 1)
        below = ws - (chunk - 1) * per_chunk
        need = np.where(ds, below < per_chunk, below > 0)
        v = np.where(need[..., None], _chunk_words(rows, bs, chunk), 0)
        share = COUNT[layout](v, cs, below, np.where(ds, M32, 0))
        below2 = below - 16 * per_chunk
        extra = below2 > 0
        assert not (extra & ds).any() and (bs[extra] == nrows - 1).all()
        v2 = np.where(extra[..., None], _chunk_words(
            rows, bs, np.minimum(chunk + 16, 31)), 0)
        share = share + np.where(extra, COUNT[layout](v2, cs, below2, 0), 0)
        assert (share < 2**16).all()
        both = (share << (16 * hi)).sum(1, keepdims=True) & M32
        mine = np.where(hi == 1, both >> 16, both & 0xFFFF)
        part = np.where(h == s, mine, part)
    out = np.where(down, counter - part, counter + part)
    return out.reshape(-1)[live.reshape(-1)] & M32


def nib_marks(word, rep):
    """``nib_marks``: bit 4i + 3 set where nibble i of word equals c."""
    y = (word ^ rep) & M32
    t = y & 0x77777777
    return ~((t + 0x77777777) | y) & 0x88888888


def nib_count4(words, rep):
    """``nib_count4``: the four words' marks shifted onto distinct bits,
    one popcount (words (..., 4))."""
    return popc(nib_marks(words[..., 0], rep) |
                nib_marks(words[..., 1], rep) >> 1 |
                nib_marks(words[..., 2], rep) >> 2 |
                nib_marks(words[..., 3], rep) >> 3)


NO_MATCH = M32   # a word not loaded: nibble 15 equals no c


def nib_any_model(buf, offset, row_words, nrows, c, j):
    """``rank_rows_nib_any_kernel<G, U>`` lane by lane over a table of
    ``row_words`` words a row stored at word ``offset`` of ``buf`` (uint32
    as int64, the table's base at (offset % 4) words past a 16-byte
    boundary): each query's whole words split into head (lanes 0-2),
    body int4s (lane g: g, g + G, ...) and tail (lanes 3-5), the partial
    word on lane 6; every counted word is loaded exactly once and nothing
    outside the query's row; one sum a step (packed for two half-warp
    queries), parked in the owner lane."""
    G = 16 if row_words <= rank.CNT_WORDS + 128 else 32
    nw = row_words - rank.CNT_WORDS
    per_row = 8 * nw
    mis = offset % 4
    cq, jq, live = _warps(c, j)
    b = jq // per_row
    within = jq - b * per_row
    down = (within >= 4 * nw) & (b < nrows - 1)
    counter = buf[offset + (b + down) * row_words + cq]
    g = LANES & (G - 1)
    part = np.zeros_like(jq)
    word = lambda k: buf[offset + k]
    for s in range(G):
        src = np.broadcast_to((LANES & ~(G - 1)) | s, jq.shape)
        bs, ws, cs, ds = (_owner_gather(x, src) for x in (b, within, cq,
                                                          down))
        rep = cs * 0x11111111
        fw, r = ws >> 3, ws & 7
        base = bs * row_words + rank.CNT_WORDS
        ga = base + np.where(ds, fw + (r != 0), 0)
        ge = base + np.where(ds, nw, fw)
        A = np.minimum(ga + ((-(mis + ga)) & 3), ge)
        E = np.maximum(ge - ((mis + ge) & 3), A)
        assert ((mis + A) % 4 == 0)[A < E].all()
        nbody = (E - A) >> 2
        k = np.full(jq.shape, -1)
        k = np.where((g < 3) & (ga + g < A), ga + g, k)
        k = np.where((g >= 3) & (g < 6) & (E + g - 3 < ge), E + g - 3, k)
        k = np.where((g == 6) & (r != 0), base + fw, k)
        sm = np.where((g == 6) & (r != 0),
                      low_mask(4 * r) ^ np.where(ds, M32, 0), M32)
        sv = np.where(k >= 0, word(np.maximum(k, 0)), NO_MATCH)
        share = popc(nib_marks(sv, rep) & sm)
        # each scalar lane's word lies in its part: the head [ga, A), the
        # tail [E, ge), the partial word
        head, tail = (g < 3) & (k >= 0), (g >= 3) & (g < 6) & (k >= 0)
        assert ((k >= ga) & (k < A))[head].all()
        assert ((k >= E) & (k < ge))[tail].all()
        assert (k == base + fw)[(g == 6) & (k >= 0)].all()
        nload = (k >= 0).astype(np.int64)
        for t in range(-(-int(nbody.max(initial=0)) // G)):
            kk = g + t * G
            ok = kk < nbody
            at = np.where(ok, A + 4 * kk, 0)
            v = np.stack([np.where(ok, word(at + e), NO_MATCH)
                          for e in range(4)], axis=-1)
            share = share + nib_count4(v, rep)
            nload = nload + 4 * ok
        # so every counted word of the group's query is loaded once, and
        # nothing else: the parts are disjoint and their sizes add up
        grp = nload.reshape(-1, 32 // G, G).sum(-1)
        want = (ge - ga + (r != 0)).reshape(-1, 32 // G, G)[..., 0]
        assert np.array_equal(grp, want)
        assert (share < 2**16).all() or G == 32
        if G == 16:
            both = (share << (16 * (LANES >> 4))).sum(1, keepdims=True) & M32
            mine = np.where(LANES >> 4, both >> 16, both & 0xFFFF)
        else:
            mine = np.broadcast_to(share.sum(1, keepdims=True) & M32,
                                   jq.shape)
        part = np.where(g == s, mine, part)
    out = np.where(down, counter - part, counter + part) & M32
    return out.reshape(-1)[live.reshape(-1)]


def _bwt(n, seed):
    """A random BWT over 0..3 with N (4) and SEP (5) runs and one
    sentinel (6)."""
    rng = np.random.default_rng(seed)
    bwt = rng.integers(0, 4, n).astype(np.uint8)
    bwt[rng.choice(n, n // 20, replace=False)] = 4
    bwt[rng.choice(n, 7, replace=False)] = 5
    bwt[rng.integers(n)] = 6
    return bwt


# 4 nibble rows and 9 K0 rows; each table's last row is partial (pads)
N = 4 * rank.NIB_PER_ROW + 301


def _tables(layout, bwt):
    """(port table as int64 numpy, JAX table, JAX rank function); the two
    tables are asserted equal."""
    if layout == "k0":
        jrows, jfn = jax_build_rows(jnp.asarray(bwt)), jax_rank_rows_xla
        rows = rank._build_rows(torch.from_numpy(bwt))
    else:
        jrows, jfn = jax_build_rows_nib(jnp.asarray(bwt)), jax_rank_rows_nib
        rows = rank._build_rows_nib(torch.from_numpy(bwt))
    assert np.array_equal(np.asarray(jrows).astype(np.int64),
                          rows.numpy().astype(np.int64) & M32)
    return rows, jrows, jfn


def _every_position(layout, nrows):
    """Every w of the first, a middle and the last row, with every c."""
    per_row = LAYOUTS[layout][0]
    j = np.concatenate([r * per_row + np.arange(per_row)
                        for r in (0, nrows // 2, nrows - 1)])
    return np.repeat(j, 4), np.tile(np.arange(4), j.size)


@pytest.mark.parametrize("seed", [300, 301])
@pytest.mark.parametrize("layout", ["k0", "nib"])
def test_nearer_counter_equals_jax_and_plain(layout, seed):
    bwt = _bwt(N, seed)
    rows, jrows, jfn = _tables(layout, bwt)
    nrows = rows.shape[0]
    j, c = _every_position(layout, nrows)
    want = np.asarray(jfn(jrows, jnp.asarray(c, jnp.int32),
                          jnp.asarray(j, jnp.int32))).astype(np.int64)
    plain = (rank.rank_rows_plain if layout == "k0" else
             rank.rank_rows_nib_plain)(rows, torch.from_numpy(
                 c.astype(np.int32)), torch.from_numpy(j.astype(np.int32)))
    assert np.array_equal(plain.numpy(), want)
    table = rows.numpy()
    # pairs: each position with a random partner of the same c (rows, halves
    # and directions mixed), and with itself
    perm = np.random.default_rng(seed).permutation(j.size // 4)
    partner = (perm[:, None] * 4 + np.arange(4)).reshape(-1)
    totals = last_row_totals(table, layout)
    assert np.array_equal(totals, [(bwt == x).sum() for x in range(4)])
    for jhi_idx in (partner, np.arange(j.size)):
        lo, hi = occ2_model(table, layout, c, j, j[jhi_idx], totals)
        assert np.array_equal(lo, want)
        assert np.array_equal(hi, want[jhi_idx])


# queries a call: whole warps, and ragged last warps of 1, 31, 33, 32k + 17
NQ_CUTS = [None, 1, 31, 33, 32 * 40 + 17]


@pytest.mark.parametrize("nq_cut", NQ_CUTS)
@pytest.mark.parametrize("seed", [304, 305])
@pytest.mark.parametrize("layout", ["k0", "nib"])
def test_standalone_rows_kernel_equals_jax_and_plain(layout, seed, nq_cut):
    """``rank_rows_kernel<Layout>``'s two-queries-a-step count (every
    position of the first, a middle and the last row with every c, in a
    random order, so each half's c, row and direction differ from the
    other's; the last row counts up) == JAX == plain; also on a one-row
    table, whose every position counts up."""
    for n in (N, LAYOUTS[layout][0] // 2 + 3):
        bwt = _bwt(n, seed)
        rows, jrows, jfn = _tables(layout, bwt)
        j, c = _every_position(layout, rows.shape[0])
        order = np.random.default_rng(seed).permutation(j.size)[:nq_cut]
        j, c = j[order], c[order]
        want = np.asarray(jfn(jrows, jnp.asarray(c, jnp.int32),
                              jnp.asarray(j, jnp.int32))).astype(np.int64)
        plain = (rank.rank_rows_plain if layout == "k0" else
                 rank.rank_rows_nib_plain)(rows, torch.from_numpy(
                     c.astype(np.int32)), torch.from_numpy(j.astype(np.int32)))
        assert np.array_equal(plain.numpy(), want)
        got = rank_rows_model(rows.numpy().astype(np.int64), layout, c, j)
        assert np.array_equal(got, want)


ANY_WIDTHS = [5, 6, 7, 8, 130, 131, 512]


@functools.cache
def _any_width_case(row_words):
    """(bwt, port table, every position of the first, a middle and the
    last row with every c in a random order, the JAX counts) at a width;
    the table holds 3 rows and a partial last one."""
    per_row = 8 * (row_words - rank.CNT_WORDS)
    bwt = _bwt(3 * per_row + per_row // 3 + 1, 306 + row_words)
    rows = rank._build_rows_nib(torch.from_numpy(bwt), row_words)
    jrows = jax_build_rows_nib(jnp.asarray(bwt), row_words)
    assert np.array_equal(np.asarray(jrows).astype(np.int64),
                          rows.numpy().astype(np.int64) & M32)
    j = np.concatenate([r * per_row + np.arange(per_row)
                        for r in (0, rows.shape[0] // 2, rows.shape[0] - 1)])
    j, c = np.repeat(j, 4), np.tile(np.arange(4), j.size)
    order = np.random.default_rng(row_words).permutation(j.size)
    j, c = j[order], c[order]
    want = np.asarray(jax_rank_rows_nib(
        jrows, jnp.asarray(c, jnp.int32),
        jnp.asarray(j, jnp.int32))).astype(np.int64)
    return rows, j, c, want


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("row_words", ANY_WIDTHS)
def test_nib_any_width_kernel_equals_jax_and_plain(row_words, offset):
    """``rank_rows_nib_any_kernel``'s head / body / tail count, a table at
    ``offset`` words past a 16-byte boundary, every position of three rows
    with every c (up and down, the last row up) == JAX == plain."""
    rows, j, c, want = _any_width_case(row_words)
    plain = rank.rank_rows_nib_plain(rows, torch.from_numpy(
        c.astype(np.int32)), torch.from_numpy(j.astype(np.int32)))
    assert np.array_equal(plain.numpy(), want)
    table = rows.numpy().astype(np.int64) & M32
    buf = np.concatenate([np.full(offset, 0x66666666), table.reshape(-1)])
    got = nib_any_model(buf, offset, row_words, rows.shape[0], c, j)
    assert np.array_equal(got, want)


def test_vcmpeq4_masked_count_equals_byte_compare():
    """K0's chunk count (``__vcmpeq4``, the per-byte mask, ``__popc`` / 8)
    == the byte compare, for every c, every ``below`` from well under 0
    to well past 16 and both directions, on random chunks and on chunks
    of one repeated byte (all 16 symbols equal to c or to a special)."""
    rng = np.random.default_rng(302)
    chunks = [rng.integers(0, 7, (500, 16))]
    chunks += [np.full((1, 16), s) for s in range(7)]
    chunks = np.concatenate(chunks).astype(np.int64)            # (Q, 16)
    words = sum(chunks[:, k::4] << (8 * k) for k in range(4))  # (Q, 4)
    below = np.arange(-40, 57)
    for c in range(4):
        for flip in (0, M32):
            got = count_k0(words[:, None, :], np.int64(c), below[None, :],
                           flip)
            sym = np.arange(16)
            side = sym[None, None, :] < below[None, :, None]
            if flip:
                side = ~side
            want = ((chunks[:, None, :] == c) & side).sum(-1)
            assert np.array_equal(got, want)


def test_nibble_masked_count_equals_nibble_compare():
    """The nibble chunk count (zero-nibble test under ``low_mask``) == a
    nibble compare, as above."""
    rng = np.random.default_rng(303)
    chunks = np.concatenate([rng.integers(0, 7, (500, 32))] +
                            [np.full((1, 32), s) for s in range(7)])
    chunks = chunks.astype(np.int64)
    words = np.stack([sum(chunks[:, 8 * e + i] << (4 * i) for i in range(8))
                      for e in range(4)], axis=-1)
    below = np.arange(-40, 73)
    for c in range(4):
        for flip in (0, M32):
            got = count_nib(words[:, None, :], np.int64(c), below[None, :],
                            flip)
            side = np.arange(32)[None, None, :] < below[None, :, None]
            if flip:
                side = ~side
            want = ((chunks[:, None, :] == c) & side).sum(-1)
            assert np.array_equal(got, want)


def test_low_mask_is_the_clamped_prefix():
    bits = np.arange(-70, 80)
    want = [(1 << min(max(b, 0), 32)) - 1 for b in bits]
    assert low_mask(bits).tolist() == want
    assert popc(low_mask(bits)).tolist() == np.clip(bits, 0, 32).tolist()

"""Numpy models of the scan kernel's row counts (``csrc/rank.cu``) against
the JAX package's rank functions, on the CPU.

The kernel counts occ(c, j) from the nearer of two counters: a position in
the lower half of its row counts the symbols below it up from the row's
counter; one in the upper half counts the symbols at and above it down
from the next row's counter (in the table's last row, from occ(c, n),
which each warp counts once).
``occ2_warp`` gives each position of a pair a half-warp, reads only the
16-byte chunks that hold counted symbols, packs both halves' counts into
one 32-bit sum and swaps the halves' results; ``occ_warp`` (the
standalone kernels) counts up from the row's own counter. The models
below follow those device functions lane by lane (chunk, load predicate,
``low_mask`` built as ``__funnelshift_lc`` clamps it, ``__vcmpeq4`` for K0,
the zero-nibble test for the nibble table) and are held, over every
position of the first, a middle and the last row of a table built from a
seeded random BWT with specials (N, SEP, the sentinel and the pad), and
every c, to the JAX package's ``rank_rows_xla`` / ``rank_rows_nib`` (on
the CPU) and to the port's plain versions. Tolerance: exact (integers).
"""

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


def occ_model(rows, layout, c, j):
    """``occ_warp`` (the standalone kernels): lane 0 the counters, lane
    t >= 1 chunk t if it holds a symbol below the position."""
    per_row, per_chunk = LAYOUTS[layout]
    j = np.broadcast_to(j[:, None], (j.size, 32))
    c = np.broadcast_to(c[:, None], j.shape)
    b = j // per_row
    below = j - b * per_row - (LANES - 1) * per_chunk
    need = (LANES == 0) | (below > 0)
    v = np.where(need[..., None], _chunk_words(rows, b, LANES), 0)
    counter = np.take_along_axis(v, c[..., None], -1)[..., 0]
    share = np.where(LANES == 0, counter, COUNT[layout](v, c, below, 0))
    return share.sum(1) & M32


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
    assert np.array_equal(occ_model(table, layout, c, j), want)




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

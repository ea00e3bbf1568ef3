"""Port vs JAX package: the seed tables' kernels, modelled on the CPU.

The kernels of ``kernels/csrc/seedkeys.cu`` (the window packer behind
``packed_key_words``, the plane pass and gather behind
``seed_table_rows``) and ``kernels/csrc/buckets.cu`` (the boundary fill
behind ``bucket_starts``) run only on a card (tests/test_torch_cuda.py
holds them to their plain versions there). Here numpy models of their
arithmetic, step for step, are held to the JAX package on the same numpy
inputs:

* the window packer: each window from the 16-byte chunks it touches at the
  text's real address (residues 0..15), by a word select and a funnel
  shift, or byte by byte within 16 L bytes of either end (a byte past the
  text or the window read as N); the special mask, the packed lanes and
  the truncation at the first special == ``packed_key_words`` (K in
  {1, 8, 13, 14, 16, 17, 20, 31, 32}, strides 1, 8, 14, 16);
* the seed table's plane pass (31 codes a word from the packer, its flag
  in bit 0) and gather (a row's key from the one or two words under its
  window, or the packer over the text where a flag is set or the window
  runs past the text) == ``seed_table`` at K 1..32 (keys and sa_aug in
  SA order), and == ``packed_key_words`` at every row of short texts
  (lengths on and off a multiple of 31, specials on word edges and at the
  end), with the rows sent to the exact path counted;
* the boundary fill: the three gaps the grid fills, then each warp step's
  contiguous range of entries in rounds of 128 (a boundary row marks its
  first entry, a prefix max gives every entry its row), at both row
  origins and every 4-byte skew of the table == ``_build_bucket_table``
  (direct, shifted, clamped; empty buckets at both ends, long gaps, one
  bucket holding every row, n >> nb and nb >> n, ranges of every length)
  and ``_virtual_bucket_tables`` (slab bases, pads clamped into the top
  bucket); every entry written exactly once.

The CPU routes of the wrappers (their plain versions) are held to the same
outputs. Tolerance: exact — every value is an integer.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamem_tpu.dist import sharded as jsh
from slamem_tpu.engine import seed_mode as jseed
from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.utils.devcache import clear_device_caches
from slamem_tpu.utils.synth import random_genome, with_n_runs

from slamem_tpu_torch.engine import seed_mode

torch.set_num_threads(1)

_KS = [1, 8, 13, 14, 16, 17, 20, 31, 32]
_BYTE_SHIFTS = np.array([0, 8, 16, 24], np.uint32)


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


def _text(n, seed):
    """Codes with N runs, separators (one at the end, as an index text
    ends) and an all-T stretch before the end."""
    t = with_n_runs(random_genome(n, seed=seed), 3, 6, seed=seed + 1)
    t[[n // 7, n // 3, n // 3 + 1, n - 1]] = 5
    t[n - 40:n - 1] = 3
    return t


def _at_offset(text, r):
    """text copied into a larger array, as a view whose address is r
    modulo 16."""
    big = np.full(text.size + 48, 7, np.uint8)
    a = -big.ctypes.data % 16 + r
    big[a:a + text.size] = text
    return big[a:a + text.size]


# ---------------------------------------------------------------------------
# A numpy model of csrc/seedkeys.cu's pack_window, step for step
# ---------------------------------------------------------------------------

def _words(b):
    """(..., 4 w) uint8 -> (..., w) little-endian uint32 words."""
    b = b.astype(np.uint32).reshape(*b.shape[:-1], -1, 4) << _BYTE_SHIFTS
    return np.bitwise_or.reduce(b, axis=-1)


def _ge4(x):
    """0xFF in each byte of x that is >= 4 (__vcmpgeu4 against 4s)."""
    out = np.zeros_like(x)
    for sh in _BYTE_SHIFTS:
        out |= np.where(((x >> sh) & 0xFF) >= 4, np.uint32(0xFF) << sh,
                        np.uint32(0))
    return out


def _ffs(x):
    """1-based index of the lowest set bit of uint32 values (0 for 0)."""
    out = np.zeros(x.shape, np.int64)
    for b in range(31, -1, -1):
        out = np.where((x >> np.uint32(b)) & 1, b + 1, out)
    return out


def _packer_model(text, pos, k):
    """(keys int64, valid, fast) as pack_window computes them for the
    windows [pos, pos + k) of text (its real address read)."""
    lanes = 4 if k <= 16 else 8
    loads = lanes // 4 + 1
    n = text.size
    off = (text.ctypes.data + pos) & 15
    lo = pos - off
    fast = (lo >= 0) & (lo + 16 * loads <= n)
    # fast path: the 16-byte chunks the window touches, the others 0
    at = np.where(fast, lo, 0)[:, None] + np.arange(16 * loads)
    touched = (np.arange(16 * loads) // 16 * 16)[None, :] < (off + k)[:, None]
    c = _words(np.where(touched, text[np.clip(at, 0, n - 1)], 0))
    s = np.take_along_axis(c, (off >> 2)[:, None] + np.arange(lanes + 1),
                           axis=1)
    sh = (8 * (off & 3)).astype(np.uint64)[:, None]
    pair = s[:, :-1].astype(np.uint64) | (s[:, 1:].astype(np.uint64) << 32)
    x_fast = ((pair >> sh) & 0xFFFFFFFF).astype(np.uint32)   # funnelshift
    # slow path: byte by byte, past the text or the window read as N
    j = np.arange(4 * lanes)
    ch = pos[:, None] + j
    inside = (j < k)[None, :] & (ch < n)
    x_slow = _words(np.where(inside, text[np.clip(ch, 0, n - 1)], 4))
    x = np.where(fast[:, None], x_fast, x_slow)
    special = np.zeros(pos.shape, np.uint32)
    packed = np.zeros(pos.shape, np.uint64)
    for q in range(lanes):
        sp = _ge4(x[:, q])
        special |= (((sp >> 7) & 1) | ((sp >> 14) & 2) | ((sp >> 21) & 4)
                    | ((sp >> 28) & 8)) << np.uint32(4 * q)
        v = x[:, q] & np.uint32(0x03030303)
        byte = (((v & 3) << 6) | (((v >> 8) & 3) << 4)
                | (((v >> 16) & 3) << 2) | ((v >> 24) & 3))
        packed = (packed << np.uint64(8)) | byte.astype(np.uint64)
    if k < 32:
        special &= np.uint32((1 << k) - 1)
    valid = special == 0
    key = packed >> np.uint64(2 * (4 * lanes - k))
    drop = np.where(valid, 0, k - (_ffs(special) - 1))
    sd = np.where(drop == k, 0, 2 * drop).astype(np.uint64)
    key = np.where(drop == k, np.uint64(0), (key >> sd) << sd)
    if k == 32:
        key ^= np.uint64(1 << 63)
    return key.view(np.int64), valid, fast


@pytest.mark.parametrize("stride", [1, 8, 14, 16])
@pytest.mark.parametrize("k", _KS)
def test_window_packer_model_equal_jax(k, stride):
    """The packer's model at every stride-th window, the text at each
    address residue 0..15, == the JAX package's packed_key_words; both
    paths taken, valid and invalid windows (N, SEP, the text's end)."""
    text = _text(900, 610 + k)
    words, jvalid = jseed.packed_key_words(jnp.asarray(text), k, stride)
    want, jvalid = _jax_keys(words, k), np.asarray(jvalid)
    pos = np.arange(0, text.size, stride, dtype=np.int64)
    keys, ok = seed_mode.packed_key_words(torch.from_numpy(text), k, stride)
    assert np.array_equal(keys.numpy(), want)          # the CPU route
    assert np.array_equal(ok.numpy(), jvalid)
    for r in range(16):
        got, valid, fast = _packer_model(_at_offset(text, r), pos, k)
        assert np.array_equal(got, want), r
        assert np.array_equal(valid, jvalid), r
        assert fast.any() and not fast.all()
    assert jvalid.any() and not jvalid.all()


# ---------------------------------------------------------------------------
# A numpy model of the seed table's plane pass and gather (csrc/seedkeys.cu)
# ---------------------------------------------------------------------------

_FLIP = np.uint64(1 << 63)


def _plane_model(text):
    """The plane as seed_plane_kernel writes it: word w = pack_window of
    the 31 characters from 31 w shifted up 2 bits (character 31 w + c in
    bits 63 - 2 c .. 62 - 2 c), bit 0 set when pack_window found the word
    invalid (a special, or a position past the text)."""
    words = -(-text.size // 31)
    key, valid, _ = _packer_model(text, 31 * np.arange(words, dtype=np.int64),
                                  31)
    return (key.view(np.uint64) << np.uint64(2)) | (~valid).astype(np.uint64)


def _gather_model(text, sa, k):
    """(refk, sa_aug, rows on the exact path) as seed_gather_kernel computes
    them: a row whose window lies inside the text in plane words with no
    flag (the word of its start, and the next one if the window reaches
    it) takes two shifts of those words, valid; any other row takes
    pack_window over the text (its real address read)."""
    n = text.size
    plane = np.concatenate([_plane_model(text), [np.uint64(0)]])
    p = sa.astype(np.int64)
    w = p // 31
    off = (p - 31 * w).astype(np.uint64)
    two = off + np.uint64(k) > np.uint64(31)
    inside = p + k <= n
    hi = np.where(inside, plane[w], np.uint64(0))
    lo = np.where(inside & two, plane[w + 1], np.uint64(0))
    fast = inside & ((hi | lo) & np.uint64(1) == 0)
    key = ((hi << (np.uint64(2) * off))
           | (lo >> (np.uint64(62) - np.uint64(2) * off)))
    key >>= np.uint64(64 - 2 * k)
    if k == 32:
        key ^= _FLIP
    keys = key.view(np.int64).copy()
    valid = np.ones(p.size, bool)
    if (~fast).any():
        ek, ev, _ = _packer_model(text, p[~fast], k)
        keys[~fast], valid[~fast] = ek, ev
    aug = np.where(valid, sa, sa | np.int32(-(1 << 31)))
    return keys, aug, int((~fast).sum())


@pytest.fixture(scope="module")
def index():
    """A JAX index over a text with N runs, separators and an all-T end."""
    return jax_build(_text(3001, 620))   # pads at every slab count below


@pytest.mark.parametrize("k", range(1, 33))
def test_seed_table_model_equal_jax(index, k):
    """The plane pass and gather's model at every SA row (the text at each
    address residue 0..15; exact-path rows at the N runs, separators and
    the end) == the JAX package's seed_table (keys, and sa_aug with the
    sign bit where the window is invalid); the CPU route of
    seed_table_rows too."""
    jrefk, jsa_aug = jseed.seed_table(index, k)
    want, jsa_aug = _jax_keys(jrefk, k), np.asarray(jsa_aug)
    text, sa = np.array(index.text), np.array(index.sa)
    refk, sa_aug = seed_mode.seed_table_rows(torch.from_numpy(text),
                                             torch.from_numpy(sa), k)
    assert np.array_equal(refk.numpy(), want)
    assert np.array_equal(sa_aug.numpy(), jsa_aug)
    for r in range(16):
        got, aug, exact = _gather_model(_at_offset(text, r), sa, k)
        assert np.array_equal(got, want), r
        assert np.array_equal(aug, jsa_aug), r
        assert 0 < exact < sa.size // 2, r
    assert np.all(want[1:] >= want[:-1])                 # sorted


def _edge_text(n, variant, seed):
    """Codes of length n: "clean" (no special: only the last word's past-
    the-text positions flag it), "edges" (N at the last code of a plane
    word and the first of another, and at 0, the text ending in SEP),
    "ends" (the last 1..3 codes SEP / N, and a special at the last word's
    start)."""
    t = np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)
    if variant == "edges":
        t[30::93], t[62::93] = 4, 4
        t[[0, n - 1]] = [4, 5]
    elif variant == "ends":
        t[-min(n, 3):] = [5, 4, 5][-min(n, 3):]
        t[(n - 1) // 31 * 31] = 5
    return t


_EDGE_KS = [1, 13, 14, 16, 17, 31, 32]


@pytest.mark.parametrize("n", [1, 30, 31, 32, 62, 63, 65, 93, 161, 1000])
def test_seed_plane_edges_equal_jax(n):
    """The plane pass and gather's model on short texts whose length is or
    is not a multiple of 31 (and of 32), with no special, specials on both
    sides of word edges, and specials at the end; every position a row (so
    every p mod 31 below n), K 1, 13, 14, 16, 17, 31, 32 (windows inside
    one word and straddling two), the text at address residues 0..15 ==
    the JAX package's packed_key_words gathered at those rows."""
    rows = np.random.default_rng(640 + n).permutation(n).astype(np.int32)
    for variant in ("clean", "edges", "ends"):
        text = _edge_text(n, variant, 641 + n)
        # the words holding a special or a position past the text
        pad = np.full(-(-n // 31) * 31 + 31, 4, np.uint8)
        pad[:n] = text
        special = (pad.reshape(-1, 31) >= 4).any(axis=1)
        for k in _EDGE_KS:
            # the rows the gate sends to the exact path: those whose window
            # runs past the text or touches a special word
            gated = ((rows + k > n) | special[rows // 31]
                     | special[(rows + k - 1) // 31]).sum()
            words, jvalid = jseed.packed_key_words(jnp.asarray(text), k, 1)
            want = _jax_keys(words, k)[rows]
            jaug = np.where(np.asarray(jvalid)[rows], rows,
                            rows | np.int32(-(1 << 31)))
            for r in range(16):
                got, aug, exact = _gather_model(_at_offset(text, r), rows, k)
                assert np.array_equal(got, want), (variant, k, r)
                assert np.array_equal(aug, jaug), (variant, k, r)
                assert exact == gated, (variant, k, r)
            refk, sa_aug = seed_mode.seed_table_rows(
                torch.from_numpy(text), torch.from_numpy(rows), k)
            assert np.array_equal(refk.numpy(), want), (variant, k)
            assert np.array_equal(sa_aug.numpy(), jaug), (variant, k)


def test_seed_plane_words_and_flags():
    """The plane's layout: character 31 w + c in bits 63 - 2 c .. 62 - 2 c
    of word w, bit 1 clear; bit 0 (the flag) set exactly when a code >= 4
    or a position past the text lies in the word, whatever the text's
    address."""
    rng = np.random.default_rng(650)
    text = rng.integers(0, 4, 1000).astype(np.uint8)
    text[[5, 30, 31, 300, 301, 999]] = [4, 5, 4, 4, 6, 5]
    want_flag = np.zeros(33, bool)
    want_flag[[0, 1, 9, 32]] = True
    at = np.uint64(2) * (31 - np.arange(31, dtype=np.uint64))
    for r in range(16):
        plane = _plane_model(_at_offset(text, r))
        assert plane.size == 33
        assert np.array_equal((plane & np.uint64(1)).astype(bool), want_flag)
        assert not (plane & np.uint64(2)).any()
        for w in np.flatnonzero(~want_flag):
            codes = text[31 * w:31 * w + 31].astype(np.uint64)
            assert plane[w] == (codes << at).sum(), (r, w)


# ---------------------------------------------------------------------------
# A numpy model of csrc/buckets.cu's boundary fill
# ---------------------------------------------------------------------------

_PAD = (1 << 32) - 1


def _fill_model(refk, k, bbits, shift, base=0, real=None, origin=0, skew=0):
    """(starts, writes per entry, widest warp range, 16-byte stores) as
    bucket_starts_kernel fills the table: the grid's three gaps, then each
    warp step of 128 rows (4 a lane, the steps starting at row -origin)
    its boundaries' contiguous range of entries in rounds of 32 aligned
    groups of 4 (group g = entries [4 g - skew, 4 g - skew + 4)): each
    boundary row marks its first entry's slot with its row, a prefix max
    over the round's 128 slots (4 a lane, then across the lanes, then the
    carry of the rounds before) gives each entry its row, and a lane
    stores its group as one 16-byte store where it lies inside the range,
    else one store an entry inside it."""
    n = refk.size
    nb = 1 << bbits
    real = n if real is None else min(max(real, 0), n)
    if k <= 16:
        w0 = refk
    elif k < 32:
        w0 = refk >> (2 * (k - 16))
    else:
        w0 = (refk >> 32) + (1 << 31)
    w0 = np.where(np.arange(n) < real, w0, _PAD)
    pref = np.minimum((w0 - (base << shift)) >> shift, nb - 1)
    assert pref.max(initial=0) < 1 << 31
    starts = np.full(nb + 1, -1, np.int64)
    writes = np.zeros(nb + 1, np.int64)

    def write(at, value):          # at: distinct entries
        writes[at] += 1
        starts[at] = value

    # the grid: below row 0, between the last real row and the pads, above
    # row n - 1
    if n > 0:
        write(np.arange(0, pref[0] + 1), 0)
    if 0 < real < n:
        write(np.arange(pref[real - 1] + 1, pref[real] + 1), real)
    write(np.arange((pref[n - 1] if n else -1) + 1, nb + 1), n)
    widest = wide_stores = 0
    big = np.iinfo(np.int32).max
    for s0 in range(-origin, real, 128):
        first, last = max(s0, 1), min(s0 + 127, real - 1)
        if last < first:
            continue
        lo = pref[first - 1]
        i = np.arange(s0, s0 + 128)
        p = np.where(i < first, lo, np.where(
            i > last, big, pref[np.clip(i, 0, n - 1)]))
        prev = np.concatenate([[lo], p[:-1]])   # lane 0's row 0: lo
        hi = p[last - s0]
        marked = (i <= last) & (p > prev)
        carry = 0
        for g0 in range((skew + lo + 1) >> 2, ((skew + hi) >> 2) + 1, 32):
            base_e = 4 * g0 - skew
            slots = np.zeros(128, np.int64)
            m = prev + 1 - base_e
            here = marked & (m >= 0) & (m < 128)
            slots[m[here]] = i[here]
            v = np.maximum(np.maximum.accumulate(slots), carry)
            carry = v[-1]
            e = (base_e + np.arange(128)).reshape(32, 4)
            inside = (e > lo) & (e <= hi)
            wide_stores += int(inside.all(axis=1).sum())
            write(e[inside], v.reshape(32, 4)[inside])
        widest = max(widest, hi - lo)
    return starts, writes, widest, wide_stores


def _jax_starts(w0, bbits, shift):
    """The JAX package's _build_bucket_table over uint32 word 0."""
    return np.asarray(jseed._build_bucket_table(
        jnp.asarray(w0.astype(np.uint32)), bbits, shift)[0])


def _keys_of_word0(w0, k, seed):
    """Sorted port keys whose word 0 is w0 (sorted), the lower
    characters (k > 16) random."""
    if k <= 16:
        return w0.astype(np.int64)
    rng = np.random.default_rng(seed)
    w1 = np.sort(rng.integers(0, 4 ** (k - 16), w0.size, dtype=np.uint64))
    return _jax_keys((w0.astype(np.uint64), w1), k)


# (name, k, bbits, shift, sorted word-0 values)
def _fill_cases():
    rng = np.random.default_rng(630)
    mid = np.sort(rng.integers(3 << 12, 5 << 12, 700))
    gaps = np.sort(np.concatenate([rng.integers(0, 40, 50),
                                   rng.integers(20_000, 20_100, 300),
                                   rng.integers(60_000, 60_010, 80)]))
    return [
        ("both ends empty", 8, 16, 0, mid),
        ("long gaps", 8, 16, 0, gaps),
        ("one bucket", 8, 16, 0, np.full(500, 12_345)),
        ("one bucket, shift", 14, 12, 8, np.full(400, 1_000_000)),
        ("shift, clamped", 14, 16, 8, np.sort(rng.integers(0, 1 << 28,
                                                          2000))),
        ("two words", 20, 16, 16, np.sort(rng.integers(1 << 20, 1 << 31,
                                                       1500))),
        ("K = 32", 32, 14, 18, np.sort(rng.integers(0, 1 << 32, 1500,
                                                    dtype=np.uint64))),
        ("empty", 8, 10, 0, np.zeros(0, np.int64)),
    ]


def _check_fill(name, refk, k, bbits, shift, want, **kwargs):
    """The fill's model == want at both row origins and every table skew,
    every entry written once; returns the model's widest range and its
    16-byte stores at origin 0, skew 0."""
    stats = None
    for origin in (0, 1):
        for skew in range(4):
            got, writes, widest, wide = _fill_model(
                refk, k, bbits, shift, origin=origin, skew=skew, **kwargs)
            assert np.array_equal(got, want), (name, origin, skew)
            assert (writes == 1).all(), (name, origin, skew)
            stats = stats or (widest, wide)
    return stats


@pytest.mark.parametrize("case", range(len(_fill_cases())))
def test_boundary_fill_model_equal_jax(case):
    """The fill's model == the JAX package's _build_bucket_table (direct,
    shifted and clamped tables; empty buckets at both ends, gaps of
    thousands of entries, one bucket holding every row, two-word keys, no
    rows), every entry written once, the steps at both row origins and the
    table at each 4-byte skew (ragged group ends at every alignment); the
    CPU route of bucket_starts too."""
    name, k, bbits, shift, w0 = _fill_cases()[case]
    refk = _keys_of_word0(w0, k, 631 + case)
    want = _jax_starts(np.asarray(w0, np.uint64), bbits, shift)
    widest, wide = _check_fill(name, refk, k, bbits, shift, want)
    port = seed_mode.bucket_starts(torch.from_numpy(refk), k, bbits, shift)
    assert port.dtype == torch.int32
    assert np.array_equal(port.numpy(), want), name
    if name == "long gaps":
        assert widest > 1000           # a warp's range: many stores
        assert wide > 250              # ... most of them 16 bytes wide


# (name, k, bbits, shift, sorted word-0 values): rows far more than
# buckets, a few rows over a wide table, and ranges of every length 0..9
# entries a row
def _fill_shape_cases():
    rng = np.random.default_rng(660)
    steps = np.cumsum(np.tile(np.arange(10), 60))
    return [
        ("n >> nb", 8, 4, 12, np.sort(rng.integers(0, 1 << 16, 3000))),
        ("n >> nb, clamped", 14, 6, 16, np.sort(rng.integers(0, 1 << 28,
                                                             2500))),
        ("nb >> n", 12, 16, 8, np.sort(rng.integers(0, 1 << 24, 40))),
        ("one row", 8, 12, 0, np.array([2_000])),
        ("ragged ranges", 8, 12, 0, steps),
        ("ragged ranges, two words", 24, 12, 0, steps),
    ]


@pytest.mark.parametrize("case", range(len(_fill_shape_cases())))
def test_fill_shapes_model_equal_jax(case):
    """The 4-rows-a-lane fill's model at the table shapes the first cases
    miss (n >> nb, nb >> n, one row, warp ranges of every length 0..9
    entries a row), at both row origins and every table skew, with pads
    from every tenth of the rows on: == the JAX package's
    _build_bucket_table, every entry written once; the CPU route too."""
    name, k, bbits, shift, w0 = _fill_shape_cases()[case]
    refk = _keys_of_word0(w0, k, 661 + case)
    want = _jax_starts(np.asarray(w0, np.uint64), bbits, shift)
    _check_fill(name, refk, k, bbits, shift, want)
    port = seed_mode.bucket_starts(torch.from_numpy(refk), k, bbits, shift)
    assert np.array_equal(port.numpy(), want), name
    n = refk.size
    for real in sorted({0, n // 10, n // 2, n - 1, n}):
        plain = seed_mode.bucket_starts(torch.from_numpy(refk), k, bbits,
                                        shift, 0, real).numpy()
        w = np.where(np.arange(n) < real, np.asarray(w0, np.uint64), _PAD)
        assert np.array_equal(plain, _jax_starts(w, bbits, shift)), real
        _check_fill(name, refk, k, bbits, shift, plain, real=real)


_SLAB_CASES = [(10, 3, 3 << 30), (10, 8, 1 << 16), (14, 3, 1 << 20),
               (24, 8, 1 << 20), (24, 301, 1 << 22)]


@pytest.mark.parametrize("k,n_slabs,budget", _SLAB_CASES)
def test_boundary_fill_slabs_equal_jax(index, k, n_slabs, budget):
    """Per slab, with its base and real rows (the pads clamped into the
    top bucket, slabs of pads alone past the last row) and the alignment
    of its rows and table row: the fill's model == the JAX package's
    virtual_slab_tables starts, every entry written once; the CPU route of
    bucket_starts (into a row of the table) too."""
    clear_device_caches()
    jrefk, _ = jseed.seed_table(index, k)
    refk = _jax_keys(jrefk, k)
    _, _, jstarts, jbases, _, shift, _, slab = jsh.virtual_slab_tables(
        index, k, n_slabs, budget)
    jstarts, jbases = np.array(jstarts), np.asarray(jbases, np.int64)
    clear_device_caches()
    n = refk.size
    R = jstarts.shape[1] - 1
    refk_p = np.concatenate([refk, np.full(slab * n_slabs - n,
                                           np.iinfo(np.int64).max)])
    out = torch.empty(jstarts.shape, dtype=torch.int32)
    pads = 0
    for i in range(n_slabs):
        rows = refk_p[i * slab:(i + 1) * slab]
        base = int(jbases[i])
        # the slab's rows and table row at their offsets in the padded
        # table and the (n_slabs, R + 1) starts
        got, writes, _, _ = _fill_model(
            rows, k, R.bit_length() - 1, shift, base, n - i * slab,
            origin=i * slab % 2, skew=i * (R + 1) % 4)
        assert np.array_equal(got, jstarts[i]), i
        assert (writes == 1).all(), i
        seed_mode.bucket_starts(torch.from_numpy(rows), k,
                                R.bit_length() - 1, shift, base,
                                n - i * slab, out=out[i])
        pads += max(0, min(slab, (i + 1) * slab - n))
    assert np.array_equal(out.numpy(), jstarts)
    assert pads == slab * n_slabs - n > 0


def test_wrappers_check_arguments():
    """The wrappers reject what the kernels do not take, on any device."""
    text = torch.zeros(10, dtype=torch.uint8)
    sa = torch.arange(10, dtype=torch.int32)
    refk = torch.arange(10, dtype=torch.int64)
    bad = [
        lambda: seed_mode.packed_key_words(text.to(torch.int32), 8),
        lambda: seed_mode.packed_key_words(text, 0),
        lambda: seed_mode.packed_key_words(text, 33),
        lambda: seed_mode.packed_key_words(text, 8, 0),
        lambda: seed_mode.seed_table_rows(text, sa.to(torch.int64), 8),
        lambda: seed_mode.seed_table_rows(text[::2], sa, 8),
        lambda: seed_mode.bucket_starts(refk.to(torch.int32), 8, 4, 0),
        lambda: seed_mode.bucket_starts(refk[:, None], 8, 4, 0),
        lambda: seed_mode.bucket_starts(refk, 8, 31, 0),   # nb >= 2^31
        lambda: seed_mode.bucket_starts(refk, 8, 4, 0, out=torch.empty(
            16, dtype=torch.int32)),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


def test_table_kernels_build_nothing_on_cpu(tmp_path):
    """Importing the key and bucket kernels' modules builds nothing and
    needs no toolkit; their wrappers on CPU tensors launch nothing."""
    code = (
        "import torch\n"
        "from slamem_tpu_torch.engine import seed_mode as s\n"
        "from slamem_tpu_torch.kernels import buckets, seedkeys\n"
        "t = torch.tensor([0, 1, 2, 3, 4, 5], dtype=torch.uint8)\n"
        "k, ok = s.packed_key_words(t, 2, 2)\n"
        "assert k.tolist() == [1, 11, 0] and ok.tolist() == [1, 1, 0]\n"
        "r, a = s.seed_table_rows(t, torch.tensor([3, 0], "
        "dtype=torch.int32), 2)\n"
        "assert r.tolist() == [12, 1] and a.tolist() == [-2**31 + 3, 0]\n"
        "assert s.bucket_starts(r.sort()[0], 2, 4, 0).tolist() == "
        "[0, 0] + [1] * 11 + [2] * 4\n"
        "assert s.packed_key_words.launches == 0\n"
        "assert s.seed_table_rows.launches == s.bucket_starts.launches == 0\n"
        "assert seedkeys.load_kernel.cache_info().currsize == 0\n"
        "assert buckets.load_kernel.cache_info().currsize == 0\n"
        "import sys; assert 'jax' not in sys.modules\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__)),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

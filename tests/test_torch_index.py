"""Port vs JAX package: FM-index build, LCP array, npz format, synth; the
suffix sort's window keys (``sa_keys_plain``) against a numpy model of
``kernels/csrc/sakeys.cu``.

Same inputs (numpy, from seeds) go through ``slamem_tpu`` and
``slamem_tpu_torch`` on the CPU. Tolerance: exact — every compared array is
integer and must be equal bit for bit (the suffix array is unique under the
order contract, so SA, BWT, occ checkpoints, C[] and LCP are determined).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.reference.lcp import lcp_plain
from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.index.lcp import lcp_adjacent as jax_lcp
from slamem_tpu.index.serialize import load_index as jax_load
from slamem_tpu.index.serialize import save_index as jax_save
from slamem_tpu.io import FastaSet
from slamem_tpu.utils import synth as jax_synth

from slamem_tpu_torch.index import build
from slamem_tpu_torch.index import lcp as lcp_module
from slamem_tpu_torch.index.build import (SA_KEY_CHARS, build_index,
                                          sa_keys_plain)
from slamem_tpu_torch.index.lcp import (LCP_WINDOW, lcp_adjacent,
                                        lcp_adjacent_plain)
from slamem_tpu_torch.index.serialize import (index_from_numpy, load_index,
                                              save_index)
from slamem_tpu_torch.utils import synth

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

FIELDS = ("text", "sa", "bwt", "occ_ckpt", "counts")


def _specials(seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, size=700).astype(np.uint8)
    t[rng.integers(0, 700, size=60)] = 4
    t[rng.integers(0, 700, size=30)] = 5
    return t


def _multi():
    seqs = [jax_synth.random_genome(n, seed=s)
            for n, s in ((900, 21), (1, 22), (400, 23))]
    lengths = np.array([len(s) for s in seqs], np.int64)
    fs = FastaSet(names=["a", "b", "c"],
                  starts=np.concatenate(([0], np.cumsum(lengths)[:-1])),
                  lengths=lengths, codes=np.concatenate(seqs))
    return fs.with_separators()[0]


TEXTS = {
    "random": lambda: jax_synth.random_genome(3000, seed=11),
    "specials": lambda: _specials(12),
    "n_runs": lambda: jax_synth.with_n_runs(
        jax_synth.random_genome(2500, seed=13), 4, 60, seed=14),
    # planted repeats: doubling runs its full round count
    "repeats": lambda: jax_synth.with_repeats(
        jax_synth.random_genome(3000, seed=15), 6, 700, seed=16),
    "low_complexity": lambda: np.tile(np.array([0, 1, 0, 2], np.uint8), 300),
    "multi_fasta": _multi,
    "single": lambda: np.array([2], np.uint8),
}


def _assert_same_index(jidx, tidx):
    for f in FIELDS:
        a = np.asarray(getattr(jidx, f))
        b = getattr(tidx, f).cpu().numpy()
        assert np.array_equal(a, b), f
    assert jidx.occ_block == tidx.occ_block


@pytest.mark.parametrize("occ_block", [16, 128])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_index_and_lcp_equal_jax(name, occ_block):
    t = TEXTS[name]()
    jidx = jax_build(t, occ_block=occ_block)
    tidx = build_index(t, occ_block=occ_block, device="cpu")
    _assert_same_index(jidx, tidx)
    assert tidx.sa.dtype == torch.int32 and tidx.bwt.dtype == torch.uint8
    want = np.asarray(jax_lcp(jidx.text, jidx.sa))
    got = lcp_adjacent(tidx.text, tidx.sa).numpy()
    assert np.array_equal(want, got)


def test_npz_round_trips_both_ways(tmp_path):
    t = TEXTS["n_runs"]()
    jidx = jax_build(t, occ_block=64)
    tidx = build_index(t, occ_block=64, device="cpu")
    # JAX-saved -> port, and port-saved -> JAX and -> port
    jax_save(str(tmp_path / "j.npz"), jidx)
    _assert_same_index(jidx, load_index(str(tmp_path / "j.npz"),
                                        device="cpu"))
    save_index(str(tmp_path / "t.npz"), tidx)
    _assert_same_index(jax_load(str(tmp_path / "t.npz")), tidx)
    _assert_same_index(jidx, load_index(str(tmp_path / "t.npz"),
                                        device="cpu"))


def test_index_from_numpy_and_its_checks():
    t = TEXTS["repeats"]()
    jidx = jax_build(t)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in FIELDS}
    _assert_same_index(jidx, index_from_numpy(arrays, jidx.occ_block, "cpu"))
    bad = dict(arrays, sa=arrays["sa"].astype(np.float32))
    with pytest.raises(ValueError):
        index_from_numpy(bad, jidx.occ_block, "cpu")
    with pytest.raises(ValueError):
        index_from_numpy(dict(arrays, bwt=arrays["bwt"][:-1]),
                         jidx.occ_block, "cpu")


def test_load_rejects_other_format_version(tmp_path):
    idx = build_index(TEXTS["random"](), device="cpu")
    save_index(str(tmp_path / "t.npz"), idx)
    with np.load(tmp_path / "t.npz") as z:
        arrays = dict(z)
    arrays["version"] = np.int64(2)
    np.savez(tmp_path / "v2.npz", **arrays)
    with pytest.raises(ValueError, match="format version"):
        load_index(str(tmp_path / "v2.npz"), device="cpu")


def test_synth_same_arrays_as_jax():
    pairs = [
        (jax_synth.random_genome(5000, seed=3, gc=0.4),
         synth.random_genome(5000, seed=3, gc=0.4)),
        (jax_synth.strain_pair(20_000, seed=20260816),
         synth.strain_pair(20_000, seed=20260816)),
        (jax_synth.strain_pair(8000, seed=5, n_repeats=4, repeat_len=300),
         synth.strain_pair(8000, seed=5, n_repeats=4, repeat_len=300)),
    ]
    base = jax_synth.random_genome(4000, seed=9)
    pairs.append((jax_synth.with_n_runs(base, 3, 50, seed=4),
                  synth.with_n_runs(base, 3, 50, seed=4)))
    pairs.append((jax_synth.mutate(base, 0.02, 0.002, seed=6),
                  synth.mutate(base, 0.02, 0.002, seed=6)))
    for want, got in pairs:
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for a, b in zip(want, got, strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The suffix sort: one sort of 27-character window keys, then doubling
# ---------------------------------------------------------------------------


def _cut_pair(offset, code, seed):
    """A random text holding one 27-character window twice, each copy with
    a special ``code`` at ``offset`` (27: just past the window)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, size=400).astype(np.uint8)
    x = rng.integers(0, 4, size=offset).astype(np.uint8)
    for at in (60, 250):
        t[at:at + offset] = x
        t[at + offset] = code
    return t


def _planted(length, seed):
    """A random text with one planted copy of a ``length``-character run."""
    t = jax_synth.random_genome(2000, seed=seed)
    t[1500:1500 + length] = t[200:200 + length]
    return t


SORT_TEXTS = {
    **{f"length{n}": (lambda n=n: jax_synth.random_genome(n, seed=70 + n))
       for n in (1, 26, 27, 28, 29)},
    **{f"special_at{o}": (lambda o=o: _cut_pair(o, 4, 80 + o))
       for o in (0, 1, 26, 27)},
    "sep_at26": lambda: _cut_pair(26, 5, 90),
    "specials_only": lambda: np.random.default_rng(91).integers(
        4, 6, size=300).astype(np.uint8),
    "all_a": lambda: np.zeros(500, np.uint8),
    "repeat120": lambda: _planted(120, 92),
    "random": lambda: jax_synth.random_genome(5000, seed=93),
}


def _expected_sorts(jidx):
    """1, plus a doubling round for each time the longest prefix two
    suffixes share (the JAX package's LCP, which never crosses a special)
    reaches the characters the ranks tell apart: 27, then 54, 108, ..."""
    longest = int(np.asarray(jax_lcp(jidx.text, jidx.sa)).max(initial=0))
    sorts, span = 1, SA_KEY_CHARS
    while longest >= span:
        sorts, span = sorts + 1, 2 * span
    return sorts


@pytest.mark.parametrize("name", sorted(SORT_TEXTS))
def test_window_key_sort_equal_jax(name):
    """SA, BWT, occ checkpoints and C[] == the JAX package's, in as many
    sorts as the longest shared prefix needs: one for a random text, at
    least three past a planted repeat of 120 (> 54) characters."""
    t = SORT_TEXTS[name]()
    jidx = jax_build(t, occ_block=16)
    before = build.suffix_array.sorts
    tidx = build_index(t, occ_block=16, device="cpu")
    sorts = build.suffix_array.sorts - before
    _assert_same_index(jidx, tidx)
    assert sorts == _expected_sorts(jidx)
    if name == "random":
        assert sorts == 1
    if name == "repeat120":
        assert sorts >= 3
    if name in ("special_at26", "sep_at26"):
        assert sorts == 1      # equal keys holding a special: new ranks
    if name == "special_at27":
        assert sorts == 2      # 27 equal characters: one doubling round


_P5 = 5 ** np.arange(10, dtype=np.int64)


def _words(b):
    """(..., 4 w) uint8 -> (..., w) little-endian uint32 words."""
    b = b.astype(np.uint32).reshape(*b.shape[:-1], -1, 4)
    return np.bitwise_or.reduce(b << np.array([0, 8, 16, 24], np.uint32),
                                axis=-1)


def _sa_keys_model(text):
    """csrc/sakeys.cu step for step in numpy: one thread per 16 positions
    i0; its 11 span words from the aligned chunks at lo = i0 - (address of
    text[i0]) % 16 where [lo, lo + 64) lies inside the text (only the
    chunks the span touches read), else bytewise with N past the text;
    per-byte digits and the special mask; rolling 9-digit groups; each
    window's cut at its first special (``window_key``); the block's readout of shared memory rows
    (row e / 8, slot e % 8 holds positions 2 e, 2 e + 1). Also returns how
    many threads took the chunk path."""
    n = text.size
    i0 = np.arange(0, n, 16)
    off = (text.ctypes.data + i0) & 15
    lo = i0 - off
    fast = (lo >= 0) & (lo + 64 <= n)
    pos = np.where(fast, lo, 0)[:, None] + np.arange(64)
    touched = (np.arange(64) // 16 * 16)[None, :] < (off + 44)[:, None]
    assert (pos[fast[:, None] & touched] < n).all()    # no read past n
    c = _words(np.where(touched, text[np.clip(pos, 0, n - 1)], 0))
    s = np.take_along_axis(c, (off >> 2)[:, None] + np.arange(12), axis=1)
    sh = (8 * (off & 3)).astype(np.uint64)[:, None]
    pair = s[:, :11].astype(np.uint64) | (s[:, 1:].astype(np.uint64) << 32)
    x_fast = ((pair >> sh) & 0xFFFFFFFF).astype(np.uint32)  # funnelshift
    bpos = i0[:, None] + np.arange(44)
    x_slow = _words(np.where(bpos < n, text[np.clip(bpos, 0, n - 1)], 4))
    x = np.where(fast[:, None], x_fast, x_slow)              # (T, 11)
    span = ((x[:, :, None] >> np.array([0, 8, 16, 24], np.uint32)) & 0xFF
            ).reshape(len(i0), 44).astype(np.int64)
    special = span >= 4
    d = np.where(special, 0, span + 1)                       # __vadd4
    mask = (special.astype(np.int64) << np.arange(44)).sum(1)
    g = np.zeros((len(i0), 34), np.int64)
    g[:, 0] = (d[:, :9] * _P5[8::-1]).sum(1)
    for p in range(33):
        g[:, p + 1] = (5 * g[:, p] - _P5[9] * d[:, p] + d[:, p + 9]) \
            % (1 << 32)
    keys = np.empty((len(i0), 16), np.int64)
    for o in range(16):                                      # window_key
        w = (mask >> o) & ((1 << SA_KEY_CHARS) - 1)
        first = np.full(len(i0), SA_KEY_CHARS, np.int64)     # __ffs - 1
        for b in range(SA_KEY_CHARS - 1, -1, -1):
            first = np.where((w >> b) & 1, b, first)
        h = [g[:, o].copy(), g[:, o + 9].copy(), g[:, o + 18].copy()]
        k = np.where(first < 9, 0, np.where(first < 18, 1, 2))
        r = 9 * (k + 1) - first
        p = ((np.where(r & 1, 5, 1) * np.where(r & 2, 25, 1))
             * np.where(r & 4, 625, 1) * np.where(r & 8, 390625, 1))
        gk = np.choose(k, h)
        cut = gk - gk % p
        some = first < SA_KEY_CHARS
        h = [np.where(some & (k == 0), cut, h[0]),
             np.where(some & (k == 0), 0,
                      np.where(some & (k == 1), cut, h[1])),
             np.where(some, np.where(k == 2, cut, 0), h[2])]
        keys[:, o] = h[0] * _P5[9] ** 2 + h[1] * _P5[9] + h[2]
    e = np.arange(len(i0) * 8)             # pair e: positions 2 e, 2 e + 1
    pairs = keys.reshape(-1, 8, 2)[e >> 3, e & 7]
    return pairs.reshape(-1)[:n], int(fast.sum())


def _at_offset(text, r):
    """text copied into a larger array, as a view whose address is r
    modulo 16."""
    big = np.full(text.size + 48, 7, np.uint8)
    a = -big.ctypes.data % 16 + r
    big[a:a + text.size] = text
    return big[a:a + text.size]


def _key_texts(seed):
    """Lengths 1..80 and around 16-byte, 64-byte and block (4,096) edges:
    random codes with specials at one position in eight, one text of
    specials only and one without."""
    rng = np.random.default_rng(seed)
    out = []
    for n in [*range(1, 81), 127, 128, 129, 4095, 4096, 4097, 5000]:
        t = rng.integers(0, 4, size=n).astype(np.uint8)
        t[rng.random(n) < 1 / 8] = rng.choice([4, 5])
        out.append(t)
    out.append(np.full(100, 4, np.uint8))
    out.append(jax_synth.random_genome(300, seed=seed))
    return out


@pytest.mark.parametrize("r", range(16))
def test_sa_keys_model_equal_plain(r):
    """At base-address residue r, every window 0..33 bytes (and more) from
    either end of each text: the kernel's model == sa_keys_plain, and both
    the chunk and the bytewise path are taken."""
    fast = 0
    for t in _key_texts(100 + r):
        view = _at_offset(t, r)
        got, nf = _sa_keys_model(view)
        fast += nf
        want = sa_keys_plain(torch.from_numpy(t)).numpy()
        assert np.array_equal(got, want), t.size
    assert fast > 0


def test_sa_keys_plain_by_definition():
    """sa_keys_plain == the definition, position by position: base-5
    digits 1..4 for A..T, 0 from the first N / SEP / past-the-text on."""
    t = _specials(15)[:200]
    got = sa_keys_plain(torch.from_numpy(t)).numpy()
    for i in range(t.size):
        key, live = 0, True
        for j in range(SA_KEY_CHARS):
            c = int(t[i + j]) if i + j < t.size else 4
            live = live and c < 4
            key = 5 * key + (c + 1 if live else 0)
        assert got[i] == key, i
    assert ((got % 5 == 0) == np.array(
        [(t[i:i + SA_KEY_CHARS] >= 4).any() or i + SA_KEY_CHARS > t.size
         for i in range(t.size)])).all()


# ---------------------------------------------------------------------------
# The LCP array by direct comparison (lcp_adjacent's plain path)
# ---------------------------------------------------------------------------


def _terminated(t):
    return np.concatenate([t, np.array([5], np.uint8)])


def _tail_repeat(length, seed):
    """N runs, two separators and a copy of a ``length``-character run
    that ends at the text's last character."""
    t = jax_synth.random_genome(2 * length + 900, seed=seed)
    t[-length:] = t[100:100 + length]
    t[length + 150:length + 175] = 4
    t[length + 400:length + 420] = 4
    t[[length + 300, length + 600]] = 5
    return t


def _contract_sa(t):
    """The suffix array of t under the order contract, by sorting: a
    special at p sorts as (0, p), below every base; a suffix that prefixes
    another sorts first."""
    def key(i):
        out = []
        for p in range(i, t.size):
            if t[p] >= 4:
                out.append((0, p))
                break
            out.append((1, int(t[p])))
        return out
    return np.array(sorted(range(t.size), key=key), np.int32)


LCP_TEXTS = {
    **{f"n{n}": (lambda n=n: _terminated(
        jax_synth.random_genome(n - 1, seed=200 + n)))
       for n in (1, 2, 17, 33, 100, 1001)},
    "random": lambda: _terminated(jax_synth.random_genome(3000, seed=210)),
    "repeats40": lambda: _terminated(jax_synth.with_repeats(
        jax_synth.random_genome(3000, seed=211), 6, 40, seed=212)),
    "repeats600": lambda: _terminated(jax_synth.with_repeats(
        jax_synth.random_genome(4000, seed=213), 4, 600, seed=214)),
    "specials_tail600": lambda: _terminated(_tail_repeat(600, 215)),
    "all_a": lambda: _terminated(np.zeros(1500, np.uint8)),
    # no terminator: the copy's prefix stops at the text's end
    "unterminated_tail40": lambda: _tail_repeat(40, 216),
}


@pytest.mark.parametrize("name", sorted(LCP_TEXTS))
def test_lcp_adjacent_equals_jax_and_lcp_plain(name):
    """lcp_adjacent (its plain path on the CPU) == the JAX package's rank
    descent == the benchmark's lcp_plain, on texts of n 1, 2, 17 and other
    lengths off 16, random, with repeats past the first window (40) and
    past a warp's step (600), N runs and separators, a repeat that runs
    into the terminator or, unterminated, into the text's end; ``stats``
    counts the pairs alike on their first LCP_WINDOW characters."""
    t = LCP_TEXTS[name]()
    text = torch.from_numpy(t)
    sa = (build.suffix_array(text) if t[-1] == 5 else
          torch.from_numpy(_contract_sa(t)))
    stats = {}
    got = lcp_adjacent(text, sa, stats)
    want = np.asarray(jax_lcp(jnp.asarray(t), jnp.asarray(sa.numpy())))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, lcp_plain(text, sa))
    assert stats == {"long_pairs": int((got >= LCP_WINDOW).sum()),
                     "launches": 0}
    longest = {"repeats40": 40, "repeats600": 600, "specials_tail600": 600,
               "all_a": 1499, "unterminated_tail40": 40}.get(name)
    if longest is not None:
        assert int(got.max()) >= longest


def test_lcp_adjacent_plain_blocks_and_checks(monkeypatch):
    """The plain version gives the same array whatever its block of pairs;
    lcp_adjacent refuses a text or suffix array it does not take."""
    t = LCP_TEXTS["repeats600"]()
    text = torch.from_numpy(t)
    sa = build.suffix_array(text)
    want = lcp_adjacent_plain(text, sa)
    monkeypatch.setattr(lcp_module, "PLAIN_BLOCK", 777)
    assert torch.equal(lcp_adjacent_plain(text, sa), want)
    with pytest.raises(ValueError):
        lcp_adjacent(text.to(torch.int16), sa)
    with pytest.raises(ValueError):
        lcp_adjacent(text, sa.to(torch.int64))
    with pytest.raises(ValueError):
        lcp_adjacent(text[::2], sa[:t.size // 2])


def _load_model(text, p, words):
    """csrc/lcp.cu's load_chars<words> at positions p in numpy: the chunk
    path where the words // 4 + 1 aligned 16-byte chunks from lo = p -
    (address of text[p]) % 16 lie inside the text (the last chunk read only
    where p is off a 16-byte boundary), a select of whole words and
    __funnelshift_r; bytewise elsewhere, N past the text. Returns the
    (len(p), words) words and how many positions took the chunk path."""
    if p.size == 0:
        return np.zeros((0, words), np.uint32), 0
    n = text.size
    k = words // 4 + 1
    off = (text.ctypes.data + p) & 15
    lo = p - off
    fast = (lo >= 0) & (lo + 16 * k <= n)
    pos = np.where(fast, lo, 0)[:, None] + np.arange(16 * k)
    touched = (np.arange(16 * k) // 16 + 1 < k)[None, :] | (off > 0)[:, None]
    assert (pos[fast[:, None] & touched] < n).all()    # no read past n
    c = _words(np.where(touched, text[np.clip(pos, 0, max(n - 1, 0))], 0))
    s = np.take_along_axis(c, (off >> 2)[:, None] + np.arange(words + 1),
                           axis=1)
    sh = (8 * (off & 3)).astype(np.uint64)[:, None]
    pair = s[:, :words].astype(np.uint64) | (s[:, 1:].astype(np.uint64)
                                             << 32)
    x_fast = ((pair >> sh) & 0xFFFFFFFF).astype(np.uint32)
    bpos = p[:, None] + np.arange(4 * words)
    x_slow = _words(np.where(bpos < n, text[np.clip(bpos, 0, max(n - 1, 0))],
                             4))
    return np.where(fast[:, None], x_fast, x_slow), int(fast.sum())


def _prefix_model(xa, xb):
    """common_prefix: per byte, __vcmpeq4 and not __vcmpgeu4(a, 4); the
    first bad byte (__ffs of the mask), 4 W where none."""
    sh = np.array([0, 8, 16, 24], np.uint32)
    ba = ((xa[..., None] >> sh) & 0xFF).reshape(xa.shape[0], -1)
    bb = ((xb[..., None] >> sh) & 0xFF).reshape(xb.shape[0], -1)
    bad = (ba != bb) | (ba >= 4)
    return np.where(bad.any(1), bad.argmax(1), bad.shape[1])


def _lcp_kernel_model(text, sa):
    """csrc/lcp.cu step for step in numpy. Pass 1, a thread a row: the
    first 32 characters of the row's own suffix; the predecessor's words
    from the lane below (row j - 1), lane 0 loading its own; rows alike on
    all 32 go to the list. Pass 2, a warp a listed row: from character 32,
    each lane 16 characters of both suffixes a step, the first lane that
    saw a bad byte ends it, else 512 further. Returns (lcp, long rows,
    chunk-path loads of pass 1, of pass 2)."""
    n = sa.size
    if n <= 1:
        return np.zeros(n, np.int32), 0, 0, 0
    j = np.arange(n)
    xb, fast1 = _load_model(text, sa.astype(np.int64), 8)
    xa = np.roll(xb, 1, axis=0)                        # __shfl_up_sync
    edge = (j % 32 == 0) & (j > 0)
    xa[edge], nf = _load_model(text, sa[j[edge] - 1].astype(np.int64), 8)
    h = np.where(j > 0, _prefix_model(xa, xb), 0)
    longs = j[h == 32]
    lanes = np.arange(32)
    fast2 = 0
    for row in longs:
        a, b, hh = int(sa[row - 1]), int(sa[row]), 32
        while True:
            x2a, fa = _load_model(text, a + hh + 16 * lanes, 4)
            x2b, fb = _load_model(text, b + hh + 16 * lanes, 4)
            fast2 += fa + fb
            d = _prefix_model(x2a, x2b)
            if (d < 16).any():                         # __ballot_sync
                first = int((d < 16).argmax())
                hh += 16 * first + int(d[first])
                break
            hh += 512
        h[row] = hh
    return h.astype(np.int32), longs.size, fast1 + nf, fast2


def _lcp_model_texts(seed):
    """Rows 1..70 (random with specials at one position in eight, and all
    A), repeats of 40 and 700 with N runs and separators."""
    rng = np.random.default_rng(seed)
    out = []
    for n in range(1, 71):
        t = rng.integers(0, 4, size=n - 1).astype(np.uint8)
        t[rng.random(n - 1) < 1 / 8] = rng.choice([4, 5])
        out += [_terminated(t), _terminated(np.zeros(n - 1, np.uint8))]
    t = jax_synth.with_repeats(jax_synth.random_genome(3000, seed=seed), 4,
                               40, seed=seed + 1)
    t = jax_synth.with_n_runs(jax_synth.with_repeats(t, 2, 700,
                                                     seed=seed + 2),
                              2, 20, seed=seed + 3)
    t[[900, 2100]] = 5
    out.append(_terminated(t))
    return out


@pytest.mark.parametrize("r", range(16))
def test_lcp_kernel_model_equal_plain(r):
    """At base-address residue r: the kernel's model == lcp_adjacent_plain
    (and its long-pair count) on every text, and both passes take the
    chunk path somewhere and the bytewise path near the ends."""
    fast1 = fast2 = 0
    for t in _lcp_model_texts(300 + r):
        text = torch.from_numpy(t)
        sa = build.suffix_array(text)
        stats = {}
        want = lcp_adjacent_plain(text, sa, stats).numpy()
        got, n_long, f1, f2 = _lcp_kernel_model(_at_offset(t, r), sa.numpy())
        fast1, fast2 = fast1 + f1, fast2 + f2
        assert np.array_equal(got, want) and n_long == stats["long_pairs"]
    assert fast1 > 0 and fast2 > 0

"""Port vs JAX package: the 2-bit packed upload wire.

The same numpy inputs (from seeds) go through ``slamem_tpu`` and
``slamem_tpu_torch`` on the CPU: the C packer, its numpy version and the
JAX packer; the plain unpack (the CUDA kernel's reference, and what
``unpack_codes`` runs on CPU tensors), a numpy model of the kernel
(``kernels/csrc/unpack2.cu``: its thread-to-word map, tail mask and the
specials' second launch) and the JAX ``unpack_codes``;
``codes_to_device``, ``query_to_device`` and the index built from a text
that rides the wire. Tolerance: exact — every compared array is uint8 or
integer and must be equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamem_tpu.engine import seed_mode as jseed
from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.utils import pack2 as jpack2

from slamem_tpu_torch.engine import seed_mode
from slamem_tpu_torch.index import build as build_mod
from slamem_tpu_torch.index.build import build_index
from slamem_tpu_torch.io.fasta import CODE_N, CODE_SEP
from slamem_tpu_torch.utils import pack2

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

OOB = 0x40000000      # the JAX side channel's pad index (dropped)


def _jax_to_device(codes, m):
    out = jpack2.codes_to_device(codes, m)
    return None if out is None else np.asarray(out)


def _port_to_device(codes, m):
    out = pack2.codes_to_device(codes, m, "cpu")
    return None if out is None else out.numpy()


@pytest.mark.parametrize("n", [4, 8, 12, 100, 1024, 4100, 65536, 1 << 20])
def test_packer_equals_plain_and_jax(n):
    """C packer == numpy SWAR == the JAX packer, codes 0..5, every length
    class mod 8."""
    codes = np.random.default_rng(n).integers(0, 6, n).astype(np.uint8)
    got = pack2.pack_codes_2bit(codes)
    assert got.dtype == np.uint8 and got.shape == (n // 4,)
    assert np.array_equal(got, pack2.pack_codes_2bit_plain(codes))
    assert np.array_equal(got, jpack2.pack_codes_2bit(codes))


@pytest.mark.parametrize("pack", ["native", "plain"])
def test_pack_layout(pack):
    """Byte j carries codes 4j..4j+3 at bits 0, 2, 4, 6."""
    fn = pack2.pack_codes_2bit if pack == "native" else \
        pack2.pack_codes_2bit_plain
    codes = np.array([0, 1, 2, 3, 3, 2, 1, 0], np.uint8)
    assert fn(codes).tolist() == [0b11100100, 0b00011011]


def test_packer_writes_into_caller_buffer():
    """The C packer fills the caller's buffer (the upload packs into a
    pinned tensor's memory) at an odd input offset, and refuses a buffer
    of the wrong size or a length not divisible by 4."""
    buf = np.random.default_rng(5).integers(0, 6, 4099).astype(np.uint8)
    codes = buf[3:]
    host = torch.zeros(1024, dtype=torch.uint8)
    out = pack2.pack_codes_2bit(codes, host.numpy())
    assert out.ctypes.data == host.data_ptr()
    assert np.array_equal(host.numpy(), jpack2.pack_codes_2bit(codes))
    with pytest.raises(ValueError):
        pack2.pack_codes_2bit(codes, np.empty(1023, np.uint8))
    with pytest.raises(ValueError):
        pack2.pack_codes_2bit(codes[:-1])


@pytest.mark.parametrize("n,m_cut,density", [
    (4, 0, 0.5), (12, 3, 0.3), (100, 0, 0.0), (4100, 7, 0.01),
    (65536, 0, 0.125), (65536, 1000, 0.2), (1 << 20, 5, 0.001)])
def test_specials_pass_equals_flatnonzero(n, m_cut, density):
    """The C pass that packs the plane finds the specials of
    codes[:m_real] that np.flatnonzero finds, in order, or declines (None)
    exactly when they are more than the cap max(16, m_real // 8)."""
    from slamem_tpu_torch._native import pack2n

    rng = np.random.default_rng(n + m_cut)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    hit = rng.random(n) < density
    codes[hit] = rng.integers(4, 6, int(hit.sum()))
    m_real = n - m_cut
    want = np.flatnonzero(codes[:m_real] >= CODE_N)
    cap = max(16, m_real // 8)
    for c in (cap, want.size, max(want.size - 1, 0)):
        plane = np.empty(n // 4, np.uint8)
        got = pack2n.pack_codes_2bit_specials(codes, m_real, c, plane)
        if want.size > c:
            assert got is None
        else:
            assert got.dtype == np.int32 and np.array_equal(got, want)
            assert np.array_equal(plane, jpack2.pack_codes_2bit(codes))


UNPACK_CASES = ["specials", "oob_pad", "past_end", "ragged", "empty_side",
                "tail_all", "full"]


def _unpack_case(name):
    """(pb, spec_idx, spec_val, m_real) of one unpack case."""
    rng = np.random.default_rng(UNPACK_CASES.index(name))
    nb = {"ragged": 1001, "empty_side": 256, "tail_all": 64}.get(name, 4097)
    pb = rng.integers(0, 256, nb).astype(np.uint8)
    n = 4 * nb
    m_real = {"tail_all": 0, "full": n, "ragged": n - 3}.get(name, n - 37)
    if name == "empty_side":
        idx = np.zeros(0, np.int32)
    else:
        idx = np.unique(np.concatenate([
            rng.integers(0, n, 40), [0, m_real - 1, n - 1]])).astype(np.int32)
        idx = idx[idx >= 0]
        if name == "oob_pad":            # the JAX bucket's pad entries
            idx = np.concatenate([idx, np.full(23, OOB, np.int32)])
        if name == "past_end":           # indices in [n, n + 16): dropped
            idx = np.concatenate([idx, np.arange(n, n + 16, dtype=np.int32)])
    val = rng.integers(4, 6, idx.size).astype(np.uint8)
    return pb, idx, val, m_real


@pytest.mark.parametrize("case", UNPACK_CASES)
def test_unpack_plain_equals_jax(case):
    """unpack_codes_plain == unpack_codes on CPU tensors == JAX unpack_codes
    on the same (pb, idx, val, m_real), out-of-range indices dropped."""
    pb, idx, val, m_real = _unpack_case(case)
    want = np.asarray(jpack2.unpack_codes(jnp.asarray(pb), jnp.asarray(idx),
                                          jnp.asarray(val),
                                          jnp.int32(m_real)))
    args = (torch.from_numpy(pb), torch.from_numpy(idx),
            torch.from_numpy(val), m_real)
    before = pack2.unpack_codes.launches
    plain = pack2.unpack_codes_plain(*args)
    assert plain.dtype == torch.uint8 and plain.shape == (4 * pb.size,)
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(pack2.unpack_codes(*args).numpy(), want)
    assert pack2.unpack_codes.launches == before    # no kernel on the CPU


# ---------------------------------------------------------------------------
# A numpy model of csrc/unpack2.cu, step for step
# ---------------------------------------------------------------------------

_THREADS, _WARP, _WORDS = 256, 32, 4    # per block; lanes; words per thread


def _thread_words(nb):
    """The dense pass's map: (threads, 4) plane word of each thread's j-th
    load (the warp's first word + 32 j + the lane) and its plane bytes
    (4, 1..3 for the ragged last word, 0 past the plane), over the grid
    slamem_unpack_codes launches."""
    nwords = -(-nb // 4)
    blocks = -(-nwords // (_THREADS * _WORDS))
    t = np.arange(blocks * _THREADS)
    w = ((t // _WARP) * _WARP * _WORDS + t % _WARP)[:, None] \
        + _WARP * np.arange(_WORDS)
    return w, np.clip(nb - 4 * w, 0, 4)


def _unpack_model(pb, idx, val, m_real):
    """unpack2.cu's output: each word's 16 codes expanded, the tail byte
    mask per 4-code lane, the store (16 bytes, or 4 per plane byte of the
    ragged word), then the specials' scatter; also how often each output
    byte was stored by the dense pass."""
    nb = pb.size
    w, nbytes = _thread_words(nb)
    w, nbytes = w[nbytes > 0], nbytes[nbytes > 0]
    plane = np.zeros(4 * (nb // 4 + 1), np.uint8)
    plane[:nb] = pb
    b = plane.reshape(-1, 4)[w].astype(np.uint32)           # (words, 4)
    o = np.zeros(b.shape, np.uint32)                        # 4-code lanes
    for c in range(4):
        o |= ((b >> np.uint32(2 * c)) & 3) << np.uint32(8 * c)
    keep = m_real - 16 * w[:, None] - 4 * np.arange(4)      # live bytes
    mask = np.where(keep <= 0, 0, 0xFFFFFFFF >> (
        32 - 8 * np.clip(keep, 1, 4))).astype(np.uint32)
    o = (o & mask) | (np.uint32(0x04040404) & ~mask)
    codes = ((o[:, :, None] >> np.arange(0, 32, 8, dtype=np.uint32))
             & 0xFF).reshape(-1, 16).astype(np.uint8)
    pos = 16 * w[:, None] + np.arange(16)
    stored = np.arange(16) < 4 * nbytes[:, None]
    out = np.zeros(4 * nb, np.uint8)
    writes = np.zeros(4 * nb, np.int64)
    out[pos[stored]] = codes[stored]
    np.add.at(writes, pos[stored], 1)
    ok = (idx >= 0) & (idx < 4 * nb)                        # second launch
    out[idx[ok]] = val[ok]
    return out, writes


@pytest.mark.parametrize("nb", [8192 + r for r in range(16)]
                         + [1, 3, 5, 63, 64, 65, 4097])
def test_unpack_thread_map_covers_every_word_once(nb):
    """Every plane word is loaded by exactly one (thread, j), a warp's j-th
    loads are 32 consecutive words (128 contiguous bytes), every output
    byte is stored once; the model == unpack_codes_plain with the tail cut
    inside the last few words and specials at both ends."""
    w, nbytes = _thread_words(nb)
    nwords = -(-nb // 4)
    live = np.sort(w[nbytes > 0])
    assert np.array_equal(live, np.arange(nwords))
    assert np.array_equal(np.sort(w.ravel()), np.arange(w.size))
    assert (nbytes[nbytes > 0] < 4).sum() == (nb % 4 > 0)
    warps = w.reshape(-1, _WARP, _WORDS)
    assert (np.diff(warps, axis=1) == 1).all()
    rng = np.random.default_rng(nb)
    pb = rng.integers(0, 256, nb).astype(np.uint8)
    m_real = 4 * nb - int(rng.integers(0, min(4 * nb, 70)))
    idx = np.unique(np.concatenate([[0, max(m_real - 1, 0), 4 * nb - 1],
                                    rng.integers(0, 4 * nb, 9)]))
    idx = idx.astype(np.int32)
    val = rng.integers(4, 6, idx.size).astype(np.uint8)
    got, writes = _unpack_model(pb, idx, val, m_real)
    assert (writes == 1).all()
    want = pack2.unpack_codes_plain(torch.from_numpy(pb),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(val), m_real)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("case", UNPACK_CASES)
def test_unpack_model_equals_jax(case):
    """The model of the two launches == the JAX unpack_codes on the same
    (pb, idx, val, m_real), out-of-range indices dropped."""
    pb, idx, val, m_real = _unpack_case(case)
    want = np.asarray(jpack2.unpack_codes(jnp.asarray(pb), jnp.asarray(idx),
                                          jnp.asarray(val),
                                          jnp.int32(m_real)))
    got, writes = _unpack_model(pb, idx, val, m_real)
    assert (writes == 1).all()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bad", ["pb_dtype", "idx_dtype", "shape", "dim"])
def test_unpack_codes_checks_arguments(bad):
    pb = torch.zeros(8, dtype=torch.uint8)
    idx = torch.zeros(2, dtype=torch.int32)
    val = torch.zeros(2, dtype=torch.uint8)
    if bad == "pb_dtype":
        pb = pb.to(torch.int32)
    elif bad == "idx_dtype":
        idx = idx.to(torch.int64)
    elif bad == "shape":
        val = val[:1]
    else:
        pb = pb.view(2, 4)
    with pytest.raises(ValueError):
        pack2.unpack_codes(pb, idx, val, 32)


@pytest.mark.parametrize("m", [1, 5, 1023, 1024, 1025, 4096, 65536, 65537,
                               70001])
def test_codes_to_device_equals_jax(m):
    """test_upload's random lengths, padded as the query is."""
    rng = np.random.default_rng(m)
    qp = seed_mode.pad_query(rng.integers(0, 4, m).astype(np.uint8))
    got = _port_to_device(qp, m)
    assert np.array_equal(got, qp)
    assert np.array_equal(got, _jax_to_device(qp, m))


def _specials_query():
    """test_upload's specials case: scattered Ns, an N run, separators,
    specials at both ends."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 50_000).astype(np.uint8)
    codes[rng.integers(0, codes.size, 200)] = CODE_N
    codes[10_000:10_500] = CODE_N
    codes[::7777] = CODE_SEP
    codes[0] = CODE_N
    codes[-1] = CODE_SEP
    return codes


def _edge_query(case):
    """Side-channel edges: specials at position 0 and m_real - 1, in the
    ragged last plane word, none at all, exactly at the 1/8 gate and one
    past it."""
    m = 40_003
    codes = np.random.default_rng(17).integers(0, 4, m).astype(np.uint8)
    if case == "first_last":
        codes[[0, m - 1]] = [CODE_SEP, CODE_N]
    elif case == "ragged_word":      # m_real 40,003: word 2,500 is cut
        codes[40_000:] = CODE_N
    elif case in ("gate", "gate_plus_one"):
        k = m // 8 + (case == "gate_plus_one")
        pos = np.random.default_rng(18).choice(m, k, replace=False)
        codes[pos] = CODE_N
    return codes


QUERIES = {"specials": _specials_query,
           **{c: (lambda c=c: _edge_query(c))
              for c in ("first_last", "ragged_word", "none", "gate",
                        "gate_plus_one")}}


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_codes_to_device_edges_equal_jax(case):
    codes = QUERIES[case]()
    m = codes.size
    qp = seed_mode.pad_query(codes)
    got, want = _port_to_device(qp, m), _jax_to_device(qp, m)
    if case == "gate_plus_one":
        assert got is None and want is None
    else:
        assert got is not None and np.array_equal(got, qp)
        assert np.array_equal(got, want)


def test_codes_to_device_special_dense_is_none():
    """More than 1/8 specials: both packages decline the wire."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 20_000).astype(np.uint8)
    codes[: codes.size // 2] = CODE_N
    qp = seed_mode.pad_query(codes)
    assert _port_to_device(qp, codes.size) is None
    assert _jax_to_device(qp, codes.size) is None


QUERY_CASES = {
    "random": lambda: np.random.default_rng(3).integers(
        0, 4, 70_001).astype(np.uint8),
    "specials": _specials_query,
    "special_dense": lambda: np.concatenate(
        [np.full(10_000, CODE_N, np.uint8),
         np.random.default_rng(1).integers(0, 4, 10_000).astype(np.uint8)]),
    # a view at an odd byte offset of a larger buffer
    "odd_offset_view": lambda: np.random.default_rng(2).integers(
        0, 4, 4099).astype(np.uint8)[3:],
}


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_query_to_device_equals_jax(case, monkeypatch):
    """Padded host codes and device codes equal the JAX package's; the
    special-dense query takes the plain upload, the others the wire."""
    codes = QUERY_CASES[case]()
    calls = []
    real = pack2.pack_wire

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(pack2, "pack_wire", spy)
    qp, qt = seed_mode.query_to_device(codes, torch.device("cpu"))
    jqp, jqt = jseed.query_to_device(codes.copy())   # fresh: no memo hit
    assert calls == [case != "special_dense"]
    assert qt.dtype == torch.uint8
    assert np.array_equal(qp, jqp)
    assert np.array_equal(qt.numpy(), np.asarray(jqt))
    assert np.array_equal(qt.numpy(), qp)


def test_build_index_wire_equals_jax_and_plain(monkeypatch):
    """A numpy text of 2^20 + 7 codes (N run, separator) rides the wire;
    the index equals the JAX package's and the port's plain-path build
    (a torch tensor input), field by field."""
    rng = np.random.default_rng(9)
    text = rng.integers(0, 4, (1 << 20) + 7).astype(np.uint8)
    text[5000:5100] = CODE_N
    text[123456] = CODE_SEP
    wired = []
    real = build_mod.codes_to_device

    def spy(*a, **k):
        wired.append(a[1])
        return real(*a, **k)

    monkeypatch.setattr(build_mod, "codes_to_device", spy)
    packed = build_index(text, device="cpu")
    assert wired == [text.size]
    plain = build_index(torch.from_numpy(text), device="cpu")
    assert wired == [text.size]                  # a tensor: plain upload
    jidx = jax_build(text)
    for f in ("text", "sa", "bwt", "occ_ckpt", "counts"):
        got = getattr(packed, f).numpy()
        assert np.array_equal(got, getattr(plain, f).numpy()), f
        assert np.array_equal(got, np.asarray(getattr(jidx, f))), f

"""Port on the card: the CUDA rank kernels (K0, the 128-word nibble kernel
and the any-width nibble kernel, and the index-level drop-ins over them), the
scan kernel (``scan_lanes``, both table layouts), the 2-bit unpack kernel
of the upload wire (``unpack_codes``), the seed engine's endpoint-extension
kernel (``extend_runs``), the seed tables' key and bucket-start kernels
(``seed_table_rows``, ``packed_key_words``, ``bucket_starts``), the index
build's occ checkpoint and window-key kernels (``occ_checkpoints``,
``sa_keys``), the scan engine's LCP kernel (``lcp_adjacent``), the scan,
seed (sort and boundary backends) and
virtual-slab engines on a CUDA device, and the mesh branches over a
one-rank NCCL group, against their plain versions / CPU runs / the
single-device engine on the same inputs.

These tests need a CUDA card (marker ``cuda``) and skip without one. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact — occ counts and match tuples are integers.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from slamem_tpu_torch.cli.main import main
from slamem_tpu_torch.config import Config
from slamem_tpu_torch.dist.mesh import make_mesh
from slamem_tpu_torch.dist.sharded import (find_seed_matches_sharded,
                                           find_seed_matches_sharded_mesh)
from slamem_tpu_torch.engine import scan_mode, seed_mode
from slamem_tpu_torch.engine.run import run_engine
from slamem_tpu_torch.engine.scan_mode import find_scan_matches
from slamem_tpu_torch.engine.seed_mode import (find_seed_matches,
                                               query_to_device)
from slamem_tpu_torch.index import build as index_build
from slamem_tpu_torch.index.build import build_index, rank_batch
from slamem_tpu_torch.io.fasta import (CODE_SEP, FastaSet, Sequence,
                                       write_fasta)
from slamem_tpu_torch.kernels import rank
from slamem_tpu_torch.utils import pack2
from slamem_tpu_torch.utils.synth import (mutate, random_genome,
                                          with_n_runs, with_repeats)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# queries a call besides the whole batch: a ragged last warp of 1, 31, 33
# and 32k + 17 queries
NQ_CUTS = (1, 31, 33, 32 * 1000 + 17)


def _edge_positions(n, nrows, per_row):
    """Every row's start, its neighbours and the half-row positions
    per_row/2 - 1, per_row/2 and per_row/2 + 1 (where the count turns from
    up to down), 0, 1, 7-9, n - 1, n, and the last row's upper half past
    n (which counts up), clipped to the table's span."""
    span = nrows * per_row
    starts = np.arange(nrows) * per_row
    half = starts + per_row // 2
    past = np.arange(max(n + 1, half[-1] - 1), span)
    past = past[np.linspace(0, past.size - 1, min(past.size, 64)).astype(
        np.int64)]
    return np.unique(np.clip(np.concatenate(
        [starts, starts + 1, starts - 1, half - 1, half, half + 1, past,
         [0, 1, 7, 8, 9, n - 1, n, span - 1]]), 0, span - 1))


def _queries(cuda, rng, edge, high, count=100_000):
    """Each edge position with every c, then ``count`` random queries with
    positions in [0, high); int32 on the card."""
    pos = np.concatenate([np.repeat(edge, 4), rng.integers(0, high, count)])
    chars = np.concatenate([np.tile(np.arange(4), edge.size),
                            rng.integers(0, 4, count)])
    return (torch.from_numpy(chars.astype(np.int32)).to(cuda),
            torch.from_numpy(pos.astype(np.int32)).to(cuda))


def _cuts_equal_plain(wrapper, plain, rows, c, p):
    """The wrapper == plain on the first 1, 31, 33 and 32k + 17 queries
    (the edges come first)."""
    for nq in NQ_CUTS:
        got = wrapper(rows, c[:nq], p[:nq])
        torch.cuda.synchronize()
        assert torch.equal(got, plain(rows, c[:nq], p[:nq])), nq


def test_rank_kernel_equals_plain(cuda):
    """K0 == its plain version and rank_batch on random queries and every
    row edge (the half-row turns, the last row's upper half past n); and
    on ragged batches."""
    t = with_n_runs(random_genome(60_000, seed=148), 2, 30, seed=149)
    idx = build_index(t, device=cuda)
    rows = rank.interleaved_rows(idx)
    rng = np.random.default_rng(147)
    edge = _edge_positions(idx.n, rows.shape[0], rank.SYMS_PER_ROW)
    c, p = _queries(cuda, rng, edge, idx.n + 1)
    before = rank.rank_rows.launches
    got = rank.rank_rows(rows, c, p)
    torch.cuda.synchronize()
    assert rank.rank_rows.launches == before + 1
    assert torch.equal(got, rank.rank_rows_plain(rows, c, p))
    inside = p <= idx.n
    assert torch.equal(got[inside], rank_batch(idx, c[inside], p[inside]))
    _cuts_equal_plain(rank.rank_rows, rank.rank_rows_plain, rows, c, p)
    with pytest.raises(ValueError):
        rank.rank_rows(rows, c, p.cpu())


@pytest.mark.parametrize("n", [60_000, 250_000])
def test_nib_kernel_equals_plain(cuda, n):
    """The nibble kernel == its plain version on random queries and every
    row edge (row starts, their neighbours, the half-row turns, n, the
    last row's upper half past n, the table's last position); and on
    ragged batches."""
    t = with_n_runs(random_genome(n, seed=160), 2, 30, seed=161)
    idx = build_index(t, device=cuda)
    rows = rank.nibble_rows(idx)
    nib_per = rank.NIB_PER_ROW
    span = rows.shape[0] * nib_per
    rng = np.random.default_rng(162)
    edge = _edge_positions(idx.n, rows.shape[0], nib_per)
    c, p = _queries(cuda, rng, edge, span)
    before = rank.rank_rows_nib.launches
    got = rank.rank_rows_nib(rows, c, p)
    torch.cuda.synchronize()
    assert rank.rank_rows_nib.launches == before + 1
    assert torch.equal(got, rank.rank_rows_nib_plain(rows, c, p))
    inside = p <= idx.n
    assert torch.equal(got[inside], rank_batch(idx, c[inside], p[inside]))
    _cuts_equal_plain(rank.rank_rows_nib, rank.rank_rows_nib_plain, rows, c,
                      p)


@pytest.mark.parametrize("row_words", [512, 2048, 4096, 130, 5, 131])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_nib_any_width_kernel_equals_plain(cuda, row_words, offset):
    """The any-width nibble kernel (rank_nib / rank_rows_nib at a width
    other than 128) == its plain version and rank_batch on random queries
    and every row edge (the half-row turns, the last row's upper half past
    n), on a table at 0-3 words past a 16-byte boundary; it alone
    launches, once a call; and == plain on ragged batches."""
    t = with_n_runs(random_genome(250_000, seed=166), 2, 30, seed=167)
    idx = build_index(t, device=cuda)
    table = rank.nibble_rows(idx, row_words)
    buf = torch.empty(table.numel() + offset, dtype=torch.int32,
                      device=cuda)
    assert buf.data_ptr() % 16 == 0
    rows = buf[offset:].view(table.shape)
    rows.copy_(table)
    per_row = rank._nib_per_row(row_words)
    span = rows.shape[0] * per_row
    rng = np.random.default_rng(row_words)
    edge = _edge_positions(idx.n, rows.shape[0], per_row)
    c, p = _queries(cuda, rng, edge, span)
    _reset_launches()
    got = rank.rank_rows_nib(rows, c, p)
    torch.cuda.synchronize()
    assert (rank.rank_rows_nib.any_launches, rank.rank_rows_nib.launches) \
        == (1, 0)
    assert torch.equal(got, rank.rank_rows_nib_plain(rows, c, p))
    inside = p <= idx.n
    assert torch.equal(got[inside], rank_batch(idx, c[inside], p[inside]))
    if offset == 0:
        assert torch.equal(rank.rank_nib(idx, c[inside], p[inside],
                                         row_words=row_words), got[inside])
        assert rank.rank_rows_nib.any_launches == 2
    _cuts_equal_plain(rank.rank_rows_nib, rank.rank_rows_nib_plain, rows, c,
                      p)


def test_index_drop_ins_on_cuda(cuda):
    """rank_pallas launches K0, rank_nib at 128 words the 128-word nibble
    kernel, rank_xla no kernel; all == rank_batch; backward_step on the
    card == on the CPU."""
    from slamem_tpu_torch.index.build import backward_step
    from slamem_tpu_torch.index.serialize import index_from_numpy

    t = with_n_runs(random_genome(60_000, seed=168), 2, 30, seed=169)
    idx = build_index(t, device=cuda)
    rng = np.random.default_rng(170)
    p = torch.from_numpy(rng.integers(0, idx.n + 1, 50_000)).to(cuda)
    c = torch.from_numpy(rng.integers(0, 4, 50_000)).to(cuda)
    want = rank_batch(idx, c, p)
    _reset_launches()
    assert torch.equal(rank.rank_pallas(idx, c, p), want)
    assert torch.equal(rank.rank_nib(idx, c, p), want)
    assert torch.equal(rank.rank_xla(idx, c, p), want)
    assert (rank.rank_rows.launches, rank.rank_rows_nib.launches,
            rank.rank_rows_nib.any_launches) == (1, 1, 0)
    cpu = index_from_numpy({f: getattr(idx, f).cpu().numpy() for f in
                            ("text", "sa", "bwt", "occ_ckpt", "counts")},
                           idx.occ_block, "cpu")
    starts = rng.integers(0, 60_000 - 20, 3 * 4096)
    pats = t[starts[:, None] + np.arange(20)].astype(np.int32)
    pats = pats[(pats < 4).all(1)][:4096]   # 20-mers of ACGT alone
    assert pats.shape[0] == 4096
    lo = torch.zeros(4096, dtype=torch.int32, device=cuda)
    hi = torch.full((4096,), idx.n, dtype=torch.int32, device=cuda)
    clo, chi = lo.cpu(), hi.cpu()
    for d in range(19, -1, -1):
        col = torch.from_numpy(np.ascontiguousarray(pats[:, d]))
        lo, hi = backward_step(idx, col.to(cuda), lo, hi)
        clo, chi = backward_step(cpu, col, clo, chi)
    assert torch.equal(lo.cpu(), clo) and torch.equal(hi.cpu(), chi)
    assert bool(((hi - lo) >= 1).all())   # each occurs in the reference


def _reset_launches():
    rank.rank_rows.launches = rank.rank_rows_nib.launches = 0
    rank.rank_rows_nib.any_launches = 0
    rank.scan_lanes.launches = dict.fromkeys(rank.SCAN_LAYOUTS, 0)


def test_scan_auto_launches_the_nib_kernel(cuda):
    """"auto" launches the scan kernel on the nibble table and no standalone
    rank kernel; "pallas" launches it on the K0 table; one launch per scan
    chunk; the two match sets are equal."""
    ref = with_n_runs(random_genome(30_000, seed=163), 3, 40, seed=164)
    qry = mutate(ref, 0.015, 0.0015, seed=165)
    idx = build_index(ref, device=cuda)
    got = {}
    for rk in ("auto", "pallas"):
        _reset_launches()
        m = find_scan_matches(idx, qry, Config(min_length=20, engine="scan",
                                               rank_kernel=rk))
        got[rk] = (m, dict(rank.scan_lanes.launches),
                   rank.rank_rows.launches + rank.rank_rows_nib.launches)
    assert got["auto"][1] == {"k0": 0, "nib": 1} and got["auto"][2] == 0
    assert got["pallas"][1] == {"k0": 1, "nib": 0} and got["pallas"][2] == 0
    for f in ("refpos", "qpos", "length"):
        assert np.array_equal(getattr(got["auto"][0], f),
                              getattr(got["pallas"][0], f))


@pytest.mark.parametrize("rank_kernel", ["pallas_interpret", "xla"])
def test_plain_rank_kernels_run_the_lockstep_loop_on_cuda(cuda, rank_kernel):
    """The explicit plain values run ``_scan_lanes`` on a CUDA index (no
    scan kernel) and give the kernel's intervals."""
    ref = with_n_runs(random_genome(30_000, seed=170), 3, 40, seed=171)
    qry = mutate(ref, 0.015, 0.0015, seed=172)[:3000]
    idx = build_index(ref, device=cuda)
    want = scan_mode.scan_intervals(idx, qry, 20)
    _reset_launches()
    got = scan_mode.scan_intervals(idx, qry, 20, rank_kernel=rank_kernel)
    assert sum(rank.scan_lanes.launches.values()) == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the row-edge case's reference: n % 992 = 800 and n % 496 = 304, in the
# upper half of both tables' last row
_ROW_EDGE_N = 252 * rank.NIB_PER_ROW + 799
_SCAN_CASES = ([("strains", n, L, lane_block) for n in (30_000, 250_000)
                for L, lane_block in ((20, 256), (12, 64), (33, 32))]
               + [("row_edges", _ROW_EDGE_N, 20, 256),
                  ("all_n", 30_000, 20, 256)])


def _scan_inputs(case: str, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(reference, query) of a scan kernel case: "strains", a multi-FASTA
    query of one strain joined by separators, with N runs; "row_edges", a
    query of two strains with N runs and a separator; "all_n", a query of
    N only."""
    if case == "all_n":
        return random_genome(n, seed=183), np.full(5_000, 4, np.uint8)
    if case == "row_edges":
        ref = with_n_runs(random_genome(n, seed=180), 3, 40, seed=181)
        parts = [with_n_runs(mutate(ref, 0.01 * k, 0.001 * k, seed=182 + k),
                             3, 25, seed=190 + k)[20_000 * k:20_000 * k
                                                  + 30_000]
                 for k in (1, 2)]
        return ref, np.concatenate([parts[0], [CODE_SEP],
                                    parts[1]]).astype(np.uint8)
    ref = with_n_runs(random_genome(n, seed=173), 3, 40, seed=174)
    mut = with_n_runs(mutate(ref, 0.015, 0.0015, seed=175), 4, 30, seed=176)
    cut = [0, n // 3, n // 3 + 50, n // 2, n - 1000]
    return ref, np.concatenate([mut[cut[0]:cut[1]], [CODE_SEP],
                                mut[cut[2]:cut[3]], [CODE_SEP],
                                mut[cut[4]:]]).astype(np.uint8)


@pytest.mark.parametrize("case,n,L,lane_block", _SCAN_CASES)
@pytest.mark.parametrize("layout", ["k0", "nib"])
def test_scan_lanes_equals_plain_loop(cuda, case, n, layout, L, lane_block):
    """The scan kernel == the lockstep loop with the plain occ on the card,
    full lo and width arrays, one launch and no standalone rank launch.
    In the row-edge case (a pyramid of 3 levels) the plain loop's trace
    shows that the kernel's occ pairs met every row-edge class of the
    nearer-counter count: w = 0, w = per_row / 2 - 1 (the last position
    counted up), per_row / 2 (the first counted down), per_row - 1, and
    j = n (the last row, counted down from occ(c, n)). An all-N query
    reads no row and matches nothing (every width 0)."""
    ref, qry = _scan_inputs(case, n)
    idx = build_index(ref, device=cuda)
    rows = (rank.nibble_rows if layout == "nib" else
            rank.interleaved_rows)(idx)
    pyr = scan_mode.get_pyramid(idx)
    qt = torch.from_numpy(qry).to(cuda)
    _reset_launches()
    got = rank.scan_lanes(rows, layout, idx.counts, pyr, qt, L, lane_block)
    torch.cuda.synchronize()
    assert rank.scan_lanes.launches[layout] == 1
    plain = rank.rank_rows_nib_plain if layout == "nib" else \
        rank.rank_rows_plain
    trace = scan_mode.ScanTrace()
    want = scan_mode._scan_lanes(idx, pyr, lambda c, p: plain(rows, c, p),
                                 qt, L, lane_block, trace)
    assert rank.rank_rows.launches + rank.rank_rows_nib.launches == 0
    if case == "all_n":
        assert int(want[1].abs().sum()) == 0
        assert sum(o.numel() for o in trace.occ) == 0
    else:
        assert int((want[1] > 0).sum()) > len(qry) // 4
    if case == "row_edges":
        assert idx.n % rank.NIB_PER_ROW == 800 and len(pyr.levels) >= 3
        j = torch.cat([o.reshape(-1) for o in trace.occ])
        per_row = rank.SCAN_LAYOUTS[layout]
        w = j % per_row
        for edge in (0, per_row // 2 - 1, per_row // 2, per_row - 1):
            assert bool((w == edge).any()), edge
        assert bool((j == idx.n).any())
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# plane lengths around the dense pass's word (4 bytes), warp (128 words)
# and block (1,024 words) edges, with the tail from m_real = 4 nb - 7
_NB_RESIDUES = [(nb, min(7, 4 * nb), side)
                for nb in (1, 2, 3, 5, 15, 16, 17, 63, 64, 65, 4095, 4096,
                           4097, 16385, 70_001)
                for side in ("none", "one", "edges", "dense")]
# the tail inside the j-th of a thread's four words (block 1, warp 3, lane
# 5; code 7 of the word), nb = 8192
_TAIL_IN_WORD = [(8192, 4 * 8192 - (16 * (1024 + 3 * 128 + 32 * j + 5) + 7),
                  side) for j in range(4) for side in ("none", "edges")]


@pytest.mark.parametrize("nb,m_cut,side", [
    (1, 1, "edges"), (3, 0, "edges"), (5, 3, "edges"), (4096, 0, "none"),
    (4097, 37, "edges"), (70_001, 5, "dense"), (70_001, 0, "oob"),
    *_NB_RESIDUES, *_TAIL_IN_WORD])
def test_unpack_kernel_equals_plain(cuda, nb, m_cut, side):
    """The unpack kernel == unpack_codes_plain on the card: ragged last
    words (nb % 4 != 0), plane lengths around the dense pass's word, warp
    and block edges, a tail of CODE_N from m_real = 4 nb - m_cut (also cut
    inside each of a thread's four words), specials at position 0,
    m_real - 1 and in the last word (with 20 random ones, or one in eight
    positions), none, one, and dropped indices past the end; one launch
    counted per call, whether the specials' scatter ran or not."""
    rng = np.random.default_rng(nb + m_cut)
    n = 4 * nb
    m_real = n - m_cut
    pb = torch.from_numpy(rng.integers(0, 256, nb).astype(np.uint8))
    idx = np.zeros(0, np.int64)
    if side == "one":
        idx = rng.integers(0, n, 1)
    elif side != "none":
        idx = np.concatenate([[0, max(m_real - 1, 0), n - 1],
                              rng.integers(0, n, n // 8 if side == "dense"
                                           else 20)])
    if side == "oob":
        idx = np.concatenate([idx, [n, n + 15, 0x40000000]])
    idx = np.unique(idx).astype(np.int32)
    val = rng.integers(4, 6, idx.size).astype(np.uint8)
    args = [t.to(cuda) for t in (pb, torch.from_numpy(idx),
                                 torch.from_numpy(val))]
    before = pack2.unpack_codes.launches
    got = pack2.unpack_codes(*args, m_real)
    torch.cuda.synchronize()
    assert pack2.unpack_codes.launches == before + 1
    want = pack2.unpack_codes_plain(*args, m_real)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), pack2.unpack_codes_plain(
        pb, torch.from_numpy(idx), torch.from_numpy(val), m_real))


@pytest.mark.parametrize("m,dense", [(1, False), (65_537, False),
                                     (1_000_003, False), (20_000, True)])
def test_codes_to_device_on_cuda(cuda, m, dense):
    """query_to_device on the card: the wire (one kernel launch) gives the
    padded host codes; a special-dense query takes the plain copy (no
    launch) and gives them too."""
    rng = np.random.default_rng(m)
    q = rng.integers(0, 4, m).astype(np.uint8)
    q[rng.integers(0, m, m // 2 if dense else 100)] = 4
    q[-1] = CODE_SEP
    before = pack2.unpack_codes.launches
    qp, qt = query_to_device(q, torch.device("cuda", 0))
    assert qt.device.type == "cuda"
    assert pack2.unpack_codes.launches == before + (not dense)
    assert np.array_equal(qt.cpu().numpy(), qp)


def test_build_index_wire_on_cuda(cuda):
    """A numpy reference of >= 2^20 codes rides the wire on the card (one
    launch) and builds the index a torch-tensor input builds."""
    text = with_n_runs(random_genome((1 << 20) + 5, seed=190), 3, 40,
                       seed=191)
    text[777] = CODE_SEP
    before = pack2.unpack_codes.launches
    wired = build_index(text, device=cuda)
    assert pack2.unpack_codes.launches == before + 1
    plain = build_index(torch.from_numpy(text), device=cuda)
    assert pack2.unpack_codes.launches == before + 1
    for f in ("text", "sa", "bwt", "occ_ckpt", "counts"):
        assert torch.equal(getattr(wired, f), getattr(plain, f)), f


OCC_TILE = 16_384   # csrc/occ.cu's tile (4 rounds of 4,096 bytes)


def _occ_lengths(block):
    """n = 1, B - 1, B, B + 1, a round's and a tile's edges +-1 and one
    past 2^20."""
    return sorted({1, max(block - 1, 1), block, block + 1, 4095, 4096, 4097,
                   OCC_TILE - 1, OCC_TILE, OCC_TILE + 1, 2 * OCC_TILE + 1,
                   (1 << 20) + 3})


def _occ_bwt(n, seed, device):
    """Codes 0..3 with N, SEP and the sentinel among them."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, size=n).astype(np.uint8)
    b[rng.integers(0, n, size=max(1, n // 40))] = 4
    b[rng.integers(0, n, size=max(1, n // 90))] = CODE_SEP
    b[rng.integers(0, n)] = index_build.BWT_SENTINEL
    return torch.from_numpy(b).to(device)


@pytest.mark.parametrize("occ_block,n", [
    (b, n) for b in (4, 16, 32, 48, 64, 96, 128, 8192, 20_000)
    for n in _occ_lengths(b)])
def test_occ_kernel_equals_plain(cuda, occ_block, n):
    """16-byte aligned BWTs: the 16-byte path wherever occ_block % 16 == 0,
    with its row and remainder carried across rounds where occ_block does
    not divide a round's 4,096 bytes (48, 96, 20,000) or exceeds it (8,192,
    20,000)."""
    bwt = _occ_bwt(n, occ_block * 131 + n, cuda)
    assert bwt.data_ptr() % 16 == 0
    before = index_build.occ_checkpoints.launches
    got = index_build.occ_checkpoints(bwt, occ_block)
    assert index_build.occ_checkpoints.launches == before + 1
    want = index_build.occ_checkpoints_plain(bwt, occ_block)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("occ_block", [5, 48, 128, 4096])
@pytest.mark.parametrize("offset", [1, 3, 8])
def test_occ_kernel_byte_path_and_offsets(cuda, occ_block, offset):
    """BWTs at byte offsets from a 16-byte boundary (the byte loop even
    where occ_block % 16 == 0) and widths other than 4-128."""
    for n in (1, occ_block, 3 * OCC_TILE + 7, (1 << 20) + 3):
        whole = _occ_bwt(n + offset, occ_block + offset + n, cuda)
        bwt = whole[offset:]
        assert bwt.data_ptr() % 16 == offset % 16
        got = index_build.occ_checkpoints(bwt, occ_block)
        want = index_build.occ_checkpoints_plain(bwt, occ_block)
        torch.cuda.synchronize()
        assert torch.equal(got, want), n


def test_build_index_launches_the_occ_kernel_once(cuda, monkeypatch):
    """A card build never takes the plain checkpoints: one launch a build,
    recorded as ``occ_launches`` in run_engine's ``index_build`` span, and
    the arrays (C[] from the last row) equal the CPU build's."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain occ checkpoints ran on CUDA tensors")

    monkeypatch.setattr(index_build, "occ_checkpoints_plain", plain)
    ref = with_n_runs(random_genome(300_001, seed=211), 3, 40, seed=212)
    before = index_build.occ_checkpoints.launches
    idx = build_index(ref, device=cuda)
    assert index_build.occ_checkpoints.launches == before + 1
    monkeypatch.undo()
    want = build_index(ref, device="cpu")
    for f in ("text", "sa", "bwt", "occ_ckpt", "counts"):
        assert torch.equal(getattr(idx, f).cpu(), getattr(want, f)), f
    monkeypatch.setattr(index_build, "occ_checkpoints_plain", plain)
    mk = lambda c: FastaSet(names=["r"], starts=np.array([0]),  # noqa: E731
                            lengths=np.array([len(c)]), codes=c)
    out = run_engine(mk(ref), mk(ref[1000:60_000].copy()),
                     Config(min_length=20), device=cuda)
    assert out.stats["phases"][0]["phase"] == "index_build"
    assert out.stats["phases"][0]["occ_launches"] == 1
    assert out.stats["phases"][0]["sa_sorts"] == 1
    assert index_build.occ_checkpoints.launches == before + 2


# text lengths around the window-key kernel's 16-position threads, its
# 42-character spans, its 64-byte chunk path and its 4,096-position blocks
SA_KEY_LENGTHS = (1, 2, 15, 16, 17, 26, 27, 28, 41, 42, 43, 63, 64, 65, 79,
                  80, 81, 4095, 4096, 4097, 3 * 4096 + 27, (1 << 20) + 3)


def _key_text(n: int, seed: int) -> np.ndarray:
    """Random codes, specials at one position in eight (N and SEP)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, size=n).astype(np.uint8)
    t[rng.random(n) < 1 / 8] = rng.choice([4, CODE_SEP])
    return t


@pytest.mark.parametrize("n", SA_KEY_LENGTHS)
def test_sa_keys_kernel_equals_plain(cuda, n):
    """The window-key kernel == sa_keys_plain, one launch a call, on a
    text at every byte offset 0..15 from a 16-byte boundary (the chunk
    path where the thread's 64 bytes lie inside the text, bytewise near
    both ends); a text of specials only and one without any."""
    texts = [_key_text(n, 300 + n), np.full(n, 4, np.uint8),
             random_genome(n, seed=301 + n)]
    for t in texts:
        text = torch.from_numpy(t).to(cuda)
        want = index_build.sa_keys_plain(text)
        for r in range(16):
            view = _offset_view(text, r)
            before = index_build.sa_keys.launches
            got = index_build.sa_keys(view)
            assert index_build.sa_keys.launches == before + 1
            torch.cuda.synchronize()
            assert got.dtype == torch.int64 and torch.equal(got, want), r


def test_sa_keys_zero_rows_launch_nothing(cuda):
    before = index_build.sa_keys.launches
    got = index_build.sa_keys(torch.empty(0, dtype=torch.uint8, device=cuda))
    assert got.shape == (0,) and got.dtype == torch.int64
    assert index_build.sa_keys.launches == before


def _cut_pair(offset: int, code: int, seed: int) -> np.ndarray:
    """One 27-character window twice, each copy with a special at
    ``offset`` (tests/test_torch_index.py's texts, by the port's synth)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, size=400).astype(np.uint8)
    x = rng.integers(0, 4, size=offset).astype(np.uint8)
    for at in (60, 250):
        t[at:at + offset] = x
        t[at + offset] = code
    return t


def _specials_text(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, size=700).astype(np.uint8)
    t[rng.integers(0, 700, size=60)] = 4
    t[rng.integers(0, 700, size=30)] = 5
    return t


def _planted(length: int, seed: int) -> np.ndarray:
    t = random_genome(2000, seed=seed)
    t[1500:1500 + length] = t[200:200 + length]
    return t


# tests/test_torch_index.py's TEXTS and SORT_TEXTS
BUILD_TEXTS = {
    "random": lambda: random_genome(3000, seed=11),
    "specials": lambda: _specials_text(12),
    "n_runs": lambda: with_n_runs(random_genome(2500, seed=13), 4, 60,
                                  seed=14),
    "repeats": lambda: with_repeats(random_genome(3000, seed=15), 6, 700,
                                    seed=16),
    "low_complexity": lambda: np.tile(np.array([0, 1, 0, 2], np.uint8), 300),
    "single": lambda: np.array([2], np.uint8),
    **{f"length{n}": (lambda n=n: random_genome(n, seed=70 + n))
       for n in (1, 26, 27, 28, 29)},
    **{f"special_at{o}": (lambda o=o: _cut_pair(o, 4, 80 + o))
       for o in (0, 1, 26, 27)},
    "specials_only": lambda: np.random.default_rng(91).integers(
        4, 6, size=300).astype(np.uint8),
    "all_a": lambda: np.zeros(500, np.uint8),
    "repeat120": lambda: _planted(120, 92),
}


@pytest.mark.parametrize("name", sorted(BUILD_TEXTS))
def test_build_index_on_cuda_equals_cpu(cuda, monkeypatch, name):
    """A card build == the CPU build (SA, BWT, occ, C[]) in as many sorts,
    with one window-key launch and never the plain keys."""
    t = BUILD_TEXTS[name]()
    before = index_build.suffix_array.sorts
    want = build_index(t, device="cpu")
    cpu_sorts = index_build.suffix_array.sorts - before

    def plain(*args, **kwargs):
        raise AssertionError("the plain window keys ran on CUDA tensors")

    monkeypatch.setattr(index_build, "sa_keys_plain", plain)
    launches = index_build.sa_keys.launches
    before = index_build.suffix_array.sorts
    idx = build_index(t, device=cuda)
    assert index_build.sa_keys.launches == launches + 1
    assert index_build.suffix_array.sorts - before == cpu_sorts
    for f in ("text", "sa", "bwt", "occ_ckpt", "counts"):
        assert torch.equal(getattr(idx, f).cpu(), getattr(want, f)), f


@pytest.mark.parametrize("engine", ["seed", "scan"])
@pytest.mark.parametrize("cap", [1 << 22, 256])
def test_boundary_backend_cuda_equals_cpu(cuda, engine, cap):
    """match_backend="boundary" on the card == on the CPU == the sort
    backend, in one round and in several."""
    ref = with_n_runs(random_genome(60_000, seed=166), 3, 40, seed=167)
    qry = with_n_runs(mutate(ref, 0.01, 0.001, seed=168), 2, 30, seed=169)
    find = find_seed_matches if engine == "seed" else find_scan_matches
    cfg = Config(min_length=20, engine=engine, pair_capacity=cap,
                 match_backend="boundary")
    got = find(build_index(ref, device=cuda), qry, cfg)
    want = find(build_index(ref, device="cpu"), qry, cfg)
    sort = find(build_index(ref, device="cpu"), qry, Config(
        min_length=20, engine=engine, sparse_seeds="off"))
    for f in ("refpos", "qpos", "length"):
        assert np.array_equal(getattr(got, f), getattr(want, f))

    def tuples(m):
        return sorted(zip(m.refpos.tolist(), m.qpos.tolist(),
                          m.length.tolist()))

    assert tuples(got) == tuples(sort) and got.length.size > 0
    assert got.stats["rounds"] == want.stats["rounds"]
    assert (got.stats["rounds"] > 1) == (cap == 256)


def test_scan_slice_cuda_equals_cpu(cuda):
    ref = with_n_runs(random_genome(30_000, seed=150), 3, 40, seed=151)
    qry = mutate(ref, 0.015, 0.0015, seed=152)
    cfg = Config(min_length=20, engine="scan")
    got = find_scan_matches(build_index(ref, device=cuda), qry, cfg)
    want = find_scan_matches(build_index(ref, device="cpu"), qry, cfg)
    for f in ("refpos", "qpos", "length"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert got.length.size > 0


@pytest.fixture(scope="module")
def big_scan_index():
    """An index on the card over 2^24 codes with N runs, a separator and
    planted repeats, and a diverged 2^20-code query of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ref = with_n_runs(with_repeats(random_genome(1 << 24, seed=160), 40,
                                   2_000, seed=161), 8, 500, seed=162)
    ref[1 << 23] = CODE_SEP
    qry = mutate(ref[:1 << 20], 0.02, 0.002, seed=163)
    return build_index(ref, device="cuda"), qry


def test_lcp_adjacent_equals_lcp_plain_on_card(big_scan_index):
    """The LCP kernel == lcp_plain where repeats of 2,000 characters send
    pairs to its second pass: two launches, long pairs counted."""
    from benchmark.reference.lcp import lcp_plain
    from slamem_tpu_torch.index.lcp import LCP_WINDOW, lcp_adjacent

    index, _ = big_scan_index
    stats = {}
    before = lcp_adjacent.launches
    got = lcp_adjacent(index.text, index.sa, stats)
    want = lcp_plain(index.text, index.sa)
    assert torch.equal(got, want) and int(want.max()) >= 2_000
    assert stats["launches"] == 2 == lcp_adjacent.launches - before
    assert stats["long_pairs"] == int((want >= LCP_WINDOW).sum()) > 0


def _lcp_case(t: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(text, sa) on ``device`` of t with its terminator, the suffix array
    sorted on the CPU."""
    text = torch.from_numpy(np.concatenate(
        [t, np.array([CODE_SEP], np.uint8)]))
    return text.to(device), index_build.suffix_array(text).to(device)


def _lcp_checked(text: torch.Tensor, sa: torch.Tensor) -> dict:
    """lcp_adjacent on the card == lcp_plain and == the CPU's plain path,
    its stats equal too; returns the card call's stats."""
    from benchmark.reference.lcp import lcp_plain
    from slamem_tpu_torch.index.lcp import lcp_adjacent

    stats, cpu_stats = {}, {}
    before = lcp_adjacent.launches
    got = lcp_adjacent(text, sa, stats)
    torch.cuda.synchronize()
    assert lcp_adjacent.launches - before == stats["launches"]
    want = lcp_adjacent(text.cpu(), sa.cpu(), cpu_stats)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    assert torch.equal(want, lcp_plain(text.cpu(), sa.cpu()))
    assert stats["long_pairs"] == cpu_stats["long_pairs"]
    return stats


def test_lcp_adjacent_one_launch_without_long_pairs(cuda):
    """A repeat-free random text: no pair reaches 32 characters, so the
    kernel launches once and reads no list."""
    text, sa = _lcp_case(random_genome(1 << 20, seed=170), cuda)
    assert _lcp_checked(text, sa) == {"long_pairs": 0, "launches": 1}


@pytest.mark.parametrize("r", range(16))
def test_lcp_adjacent_at_byte_offsets(cuda, r):
    """The text as a view at byte offset r of a larger buffer: the chunk
    path's funnel shifts, and bytewise loads near both ends, in both
    passes (repeats of 40 and 700, N runs, separators)."""
    t = with_n_runs(with_repeats(random_genome(20_000, seed=171 + r), 8,
                                 40, seed=172), 4, 30, seed=173)
    t = with_repeats(t, 3, 700, seed=174 + r)
    t[[5_000, 12_000]] = CODE_SEP
    text, sa = _lcp_case(t, cuda)
    stats = _lcp_checked(_offset_view(text, r), sa)
    assert stats["launches"] == 2 and stats["long_pairs"] > 0


@pytest.mark.parametrize("n", [*range(1, 65), (1 << 20) + 3])
def test_lcp_adjacent_lengths(cuda, n):
    """Rows 1..64 and 2^20 + 3: random codes with specials, and all A
    (every pair alike up to the terminator: long pairs from 34 rows),
    against the plain versions; fewer than 2 rows launch nothing."""
    rng = np.random.default_rng(175 + n)
    mixed = rng.integers(0, 4, size=n - 1).astype(np.uint8)
    mixed[rng.random(n - 1) < 1 / 16] = 4
    texts = [mixed, np.zeros(n - 1, np.uint8)] if n < 1 << 20 else [
        with_repeats(random_genome(n - 1, seed=176), 20, 1_500, seed=177)]
    for t in texts:
        stats = _lcp_checked(*_lcp_case(t, cuda))
        assert stats["launches"] == (0 if n == 1 else
                                     1 + (stats["long_pairs"] > 0))


@pytest.mark.parametrize("L", [20, 50])
def test_scan_intervals_equal_intervals_plain_on_card(big_scan_index, L):
    from benchmark.reference.lcp import intervals_plain

    index, qry = big_scan_index
    qt = torch.from_numpy(qry).to(index.device)
    lo, w = scan_mode.scan_intervals(index, qt, L)
    plo, pw = intervals_plain(index.text, index.sa, qt, L)
    hit = pw > 0
    assert torch.equal(w, pw) and torch.equal(lo[hit], plo[hit])
    assert int((pw > 1).sum()) > 0


@pytest.mark.parametrize("fields", [dict(min_length=20),
                                    dict(min_length=50),
                                    dict(min_length=20, frontend="join"),
                                    dict(min_length=20, pair_capacity=256)])
def test_seed_engine_cuda_equals_cpu(cuda, fields):
    """Every seed stage on the card (bucket or join frontend, span filter at
    -l 50, several rounds) gives the CPU run's matches."""
    ref = with_n_runs(random_genome(200_000, seed=153), 3, 40, seed=154)
    qry = with_n_runs(mutate(ref, 0.01, 0.001, seed=155), 2, 30, seed=156)
    cfg = Config(**fields)
    got = find_seed_matches(build_index(ref, device=cuda), qry, cfg)
    want = find_seed_matches(build_index(ref, device="cpu"), qry, cfg)
    for f in ("refpos", "qpos", "length"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert got.length.size > 0
    assert {k: got.stats[k] for k in ("pairs", "k", "stride", "rounds",
                                      "frontend")} == {
        k: want.stats[k] for k in ("pairs", "k", "stride", "rounds",
                                   "frontend")}


@pytest.mark.parametrize("n_slabs", [2, 8, 301])
def test_virtual_slabs_cuda_equals_cpu(cuda, n_slabs):
    """The n-slab program on the card (slab tables, owner-routed frontend,
    per-slab runs, on-device merge) gives the CPU run's matches and plan."""
    ref = with_n_runs(random_genome(200_000, seed=153), 3, 40, seed=154)
    qry = with_n_runs(mutate(ref, 0.01, 0.001, seed=155), 2, 30, seed=156)
    cfg = Config(min_length=20)
    got = find_seed_matches_sharded(build_index(ref, device=cuda), qry, cfg,
                                    n_slabs=n_slabs)
    want = find_seed_matches_sharded(build_index(ref, device="cpu"), qry,
                                     cfg, n_slabs=n_slabs)
    for f in ("refpos", "qpos", "length"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert got.length.size > 0
    plan = ("pairs", "k", "stride", "rounds", "shards", "shift", "probes",
            "R")
    assert {k: got.stats[k] for k in plan} == {k: want.stats[k] for k in plan}


def _extend_texts(n: int, seed: int):
    """A reference with N runs and separators and a padded query strain of
    it with N runs (numpy uint8)."""
    ref = with_n_runs(random_genome(n, seed=seed), 3, 40, seed=seed + 1)
    ref[[n // 3, n // 2]] = CODE_SEP
    qry = with_n_runs(mutate(ref % 4, 0.01, 0.001, seed=seed + 2), 2, 30,
                      seed=seed + 3)
    return ref, seed_mode.pad_query(qry)


def _extend_triples(n: int, m: int, stride: int, k: int, seed: int):
    """int64 (diag, qs_s, qe_s): half near the strain's own diagonals (runs
    that extend), half anywhere, plus boundaries at and beyond both text
    edges."""
    rng = np.random.default_rng(seed)
    m_s = -(-m // stride)
    nr = 200_000
    qs = rng.integers(-2, m_s + 2, nr)
    diag = np.where(rng.random(nr) < 0.5, rng.integers(-40, 40, nr),
                    rng.integers(-m, n + 1, nr))
    edge_q = np.array([-2, -1, 0, 1, m_s - 2, m_s - 1, m_s, m_s + 1])
    edge_d = np.concatenate([[-m - 5, -e * stride, -e * stride - 1,
                              n - e * stride - k, n - e * stride, n - 3, n,
                              n + 20] for e in edge_q])
    qs = np.concatenate([qs, np.repeat(edge_q, 8)])
    diag = np.concatenate([diag, edge_d])
    return diag, qs, qs + rng.integers(0, 8, qs.size)


@pytest.mark.parametrize("k,stride", [(13, 8), (14, 14), (24, 7)])
def test_extend_kernel_equals_plain(cuda, k, stride):
    """The extension kernel == its plain version (_extend_core over
    ext_arrays) on the card and == the CPU route, on random, real and edge
    triples; one launch; zero runs launch nothing."""
    ref, qry = _extend_texts(250_000, 190)
    trip = [torch.from_numpy(x) for x in _extend_triples(
        len(ref), len(qry), stride, k, 191 + k)]
    texts = [torch.from_numpy(ref), torch.from_numpy(qry)]
    args = [t.to(cuda) for t in trip + texts]
    before = seed_mode.extend_runs.launches
    got = seed_mode.extend_runs(*args, stride, k)
    torch.cuda.synchronize()
    assert seed_mode.extend_runs.launches == before + 1
    want = seed_mode._extend_core(*args[:3], seed_mode.ext_arrays(args[3]),
                                  seed_mode.ext_arrays(args[4]), stride, k)
    cpu = seed_mode.extend_runs(*trip, *texts, stride, k)
    for g, w, c in zip(got, want, cpu):
        assert g.dtype == torch.int64 and g.device.type == "cuda"
        assert torch.equal(g, w) and torch.equal(g.cpu(), c)
    ext = (args[1] * stride - got[0]) + (got[1] - args[2] * stride)
    assert int((ext > 0).sum()) > 1000 and int(ext.max()) >= stride - 1
    empty = seed_mode.extend_runs(*(t[:0] for t in args[:3]), *args[3:],
                                  stride, k)
    assert seed_mode.extend_runs.launches == before + 1
    assert all(e.numel() == 0 for e in empty)


def _window_triples(n: int, m: int, stride: int, k: int):
    """int64 (diag, qs_s, qe_s) whose windows lie at every distance d =
    0..33 from both ends of both texts: for each d, side and end, one
    triple puts that side's reference window and (exactly at stride 1, at
    the sample position at or below it otherwise) its query window d bytes
    from that end, and one more pairs the query's end with the
    reference's other end (tests/test_torch_extend.py's triples)."""
    d = np.arange(34)
    q_l = np.concatenate([d + 16, m - d])
    r_l = np.concatenate([d + 16, n - d])
    q_r = np.concatenate([d, m - 16 - d])
    r_r = np.concatenate([d, n - 16 - d])
    qs_l = q_l // stride
    qe_r = (q_r - k) // stride
    diag = np.concatenate([r_l - qs_l * stride, r_l[::-1] - qs_l * stride,
                           r_r - (qe_r * stride + k),
                           r_r[::-1] - (qe_r * stride + k)])
    qs = np.concatenate([qs_l, qs_l, qe_r - 1, qe_r - 1])
    qe = np.concatenate([qs_l + 1, qs_l + 1, qe_r, qe_r])
    return diag, qs, qe


def _offset_view(text: torch.Tensor, r: int) -> torch.Tensor:
    """A copy of ``text`` as the view big[r:r + n] of a larger buffer (its
    address r modulo 16: the caching allocator aligns ``big``)."""
    big = torch.full((text.numel() + 32,), 7, dtype=torch.uint8,
                     device=text.device)
    view = big[r:r + text.numel()]
    view.copy_(text)
    assert view.data_ptr() % 16 == r
    return view


@pytest.mark.parametrize("k,stride", [(13, 1), (14, 14), (24, 7)])
def test_extend_kernel_alignment_and_edges(cuda, k, stride):
    """The extension kernel == _extend_core on triples whose windows lie
    at every distance 0..33 from both ends of both texts, plus random and
    edge triples, with both texts passed as views at every byte offset
    r = 1..15 of larger buffers (and at 0); one launch each."""
    ref, qry = _extend_texts(60_000, 197)
    parts = zip(_window_triples(len(ref), len(qry), stride, k),
                _extend_triples(len(ref), len(qry), stride, k, 198))
    trip = [torch.from_numpy(np.concatenate(p)).to(cuda) for p in parts]
    texts = [torch.from_numpy(x).to(cuda) for x in (ref, qry)]
    want = seed_mode._extend_core(*trip, seed_mode.ext_arrays(texts[0]),
                                  seed_mode.ext_arrays(texts[1]), stride, k)
    for r in range(16):
        views = [_offset_view(t, r) for t in texts]
        before = seed_mode.extend_runs.launches
        got = seed_mode.extend_runs(*trip, *views, stride, k)
        torch.cuda.synchronize()
        assert seed_mode.extend_runs.launches == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want)), r


def test_extend_runs_on_cuda_never_takes_the_plain_path(cuda, monkeypatch):
    """With the plain version and the table builder made to fail, CUDA
    tensors still extend (the kernel), and a card query runs."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain path ran on CUDA tensors")

    ref, qry = _extend_texts(60_000, 195)
    args = [torch.from_numpy(x).to(cuda) for x in
            (*_extend_triples(len(ref), len(qry), 8, 13, 196), ref, qry)]
    want = seed_mode._extend_core(*args[:3], seed_mode.ext_arrays(args[3]),
                                  seed_mode.ext_arrays(args[4]), 8, 13)
    monkeypatch.setattr(seed_mode, "_extend_core", plain)
    monkeypatch.setattr(seed_mode, "ext_arrays", plain)
    got = seed_mode.extend_runs(*args, 8, 13)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    m = find_seed_matches(build_index(ref, device=cuda), qry[:50_000],
                          Config(min_length=20))
    assert m.stats["stride"] > 1 and m.length.size > 0


@pytest.mark.parametrize("fields", [dict(min_length=20),
                                    dict(min_length=50),
                                    dict(min_length=20, pair_capacity=256),
                                    dict(min_length=20, n_slabs=3)])
def test_sparse_call_launches_extension_once(cuda, fields):
    """Each sparse seed call on the card (one round, the span filter,
    several rounds, the virtual-slab program) launches the extension
    kernel once and builds no ext_table; a dense call launches none."""
    ref = with_n_runs(random_genome(200_000, seed=153), 3, 40, seed=154)
    qry = with_n_runs(mutate(ref, 0.01, 0.001, seed=155), 2, 30, seed=156)
    idx = build_index(ref, device=cuda)
    fields = dict(fields)
    n_slabs = fields.pop("n_slabs", None)
    cfg = Config(**fields)
    before = seed_mode.extend_runs.launches
    m = find_seed_matches_sharded(idx, qry, cfg, n_slabs=n_slabs)
    assert m.stats["stride"] > 1 and m.length.size > 0
    assert seed_mode.extend_runs.launches == before + 1
    assert (m.stats["rounds"] > 1) == (cfg.pair_capacity == 256)
    find_seed_matches(idx, qry, Config(min_length=20, sparse_seeds="off"))
    assert seed_mode.extend_runs.launches == before + 1
    assert "ext_table" not in idx.derived


def _table_text(n: int, seed: int) -> np.ndarray:
    """Codes with N runs, separators (one at the end) and an all-T
    stretch before the end: windows at N, SEP and the text's end."""
    t = with_n_runs(random_genome(n, seed=seed), 3, 40, seed=seed + 1)
    t[[n // 7, n // 3, n // 3 + 1, n - 1]] = CODE_SEP
    t[n - 40:n - 1] = 3
    return t


@pytest.mark.parametrize("k", range(1, 33))
def test_key_kernels_equal_plain(cuda, k):
    """The seed-table and key-pack kernels (csrc/seedkeys.cu) == their
    plain versions on the card and == the CPU route, at every K, strides
    1, 8, 14 and 16, the text also as a view at byte offsets 0..15; one
    launch each; zero rows launch nothing."""
    text = _table_text(60_001, 200)
    idx = build_index(text, device=cuda)
    want = seed_mode.seed_table_rows_plain(idx.text, idx.sa, k)
    cpu = seed_mode.seed_table_rows(idx.text.cpu(), idx.sa.cpu(), k)
    assert bool((~want[1] >> 31).any()) and bool((want[1] >> 31).any())
    packs = {s: seed_mode.packed_key_words_plain(idx.text, k, s)
             for s in (1, 8, 14, 16)}
    for r in range(16):
        view = _offset_view(idx.text, r)
        before = seed_mode.seed_table_rows.launches
        got = seed_mode.seed_table_rows(view, idx.sa, k)
        torch.cuda.synchronize()
        assert seed_mode.seed_table_rows.launches == before + 1
        assert got[0].dtype == torch.int64 and got[1].dtype == torch.int32
        for g, w, c in zip(got, want, cpu):
            assert torch.equal(g, w) and torch.equal(g.cpu(), c), r
        for s, (wk, wv) in packs.items():
            before = seed_mode.packed_key_words.launches
            gk, gv = seed_mode.packed_key_words(view, k, s)
            torch.cuda.synchronize()
            assert seed_mode.packed_key_words.launches == before + 1
            assert torch.equal(gk, wk) and torch.equal(gv, wv), (r, s)
    before = (seed_mode.seed_table_rows.launches,
              seed_mode.packed_key_words.launches)
    empty = seed_mode.seed_table_rows(idx.text, idx.sa[:0], k)
    assert all(e.numel() == 0 for e in empty)
    empty = seed_mode.packed_key_words(idx.text[:0], k, 8)
    assert all(e.numel() == 0 for e in empty)
    assert (seed_mode.seed_table_rows.launches,
            seed_mode.packed_key_words.launches) == before


def _plane_plain(text: torch.Tensor) -> torch.Tensor:
    """The seed table's plane by torch ops: word w = codes [31 w, 31 w +
    31) 2 bits each, character 31 w in bits 63..62 (specials' codes masked
    to 2 bits: only unflagged words are compared), bit 0 = a code >= 4 or
    a position past the text in the word."""
    n = text.numel()
    words = -(-n // 31)
    codes = torch.full((31 * words,), 4, dtype=torch.int64,
                       device=text.device)
    codes[:n] = text
    codes = codes.view(words, 31)
    at = 2 * (31 - torch.arange(31, device=text.device))
    plane = ((codes & 3) << at).sum(1)          # wraps into the sign bit
    return plane | (codes >= 4).any(1).to(torch.int64)


def _edge_codes(n: int, variant: str, seed: int) -> np.ndarray:
    """Codes of length n: "clean", "edges" (N at the last code of a plane
    word and the first of another, N first and SEP last) or "ends" (the
    last codes SEP / N, a special at the last word's start)."""
    t = np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)
    if variant == "edges":
        t[30::93], t[62::93] = 4, 4
        t[[0, n - 1]] = [4, CODE_SEP]
    elif variant == "ends":
        t[-min(n, 3):] = [CODE_SEP, 4, CODE_SEP][-min(n, 3):]
        t[(n - 1) // 31 * 31] = CODE_SEP
    return t


@pytest.mark.parametrize("n", [1, 30, 31, 32, 62, 63, 65, 93, 161, 1000,
                               100_003])
def test_seed_plane_and_gather_equal_plain(cuda, n):
    """The seed table's two kernels (csrc/seedkeys.cu): the plane pass's
    flags == _plane_plain's and its unflagged words too, and the gather ==
    seed_table_rows_plain with every position a row (every p mod 31), on
    texts of lengths that are and are not multiples of 31, clean, with
    specials on word edges and at the end, at K 1, 13, 14, 16, 17, 31, 32,
    the text as a view at byte offsets 0..15 (odd ones included), the rows
    as views at 4-byte offsets 0..3 (16-byte loads and row by row); one
    launch a table."""
    from slamem_tpu_torch.kernels.seedkeys import load_kernel

    kern = load_kernel()
    stream = torch.cuda.current_stream().cuda_stream
    rows = torch.from_numpy(np.random.default_rng(210 + n).permutation(n)
                            .astype(np.int32)).to(cuda)
    for variant in ("clean", "edges", "ends"):
        text = torch.from_numpy(_edge_codes(n, variant, 211 + n)).to(cuda)
        want_plane = _plane_plain(text)
        keep = (want_plane & 1) == 0
        plane = torch.empty_like(want_plane)
        want = {k: seed_mode.seed_table_rows_plain(text, rows, k)
                for k in (1, 13, 14, 16, 17, 31, 32)}
        for r in (0, 1, 3, 8, 13, 15):
            view = _offset_view(text, r)
            assert kern.seed_plane(view.data_ptr(), n, plane.data_ptr(),
                                   stream) == 0
            torch.cuda.synchronize()
            assert torch.equal(plane & 1, want_plane & 1), (variant, r)
            assert torch.equal(plane[keep], want_plane[keep]), (variant, r)
            for k, wk in want.items():
                for a in range(4):
                    big = torch.empty(n + 4, dtype=torch.int32, device=cuda)
                    sa = big[a:a + n]
                    sa.copy_(rows)
                    before = seed_mode.seed_table_rows.launches
                    got = seed_mode.seed_table_rows(view, sa, k)
                    torch.cuda.synchronize()
                    assert seed_mode.seed_table_rows.launches == before + 1
                    for g, w in zip(got, wk):
                        assert torch.equal(g, w), (variant, r, k, a)


def _bucket_case(w0: np.ndarray, k: int, seed: int) -> torch.Tensor:
    """Sorted int64 keys whose word 0 is w0 (sorted), the lower
    characters (k > 16) random."""
    if k <= 16:
        return torch.from_numpy(w0.astype(np.int64))
    rng = np.random.default_rng(seed)
    w1 = np.sort(rng.integers(0, 4 ** (k - 16), w0.size, dtype=np.uint64))
    w0 = w0.astype(np.uint64)
    if k < 32:
        key = w0 * np.uint64(4 ** (k - 16)) + w1
    else:
        key = ((w0 << np.uint64(32)) | w1) ^ np.uint64(1 << 63)
    return torch.from_numpy(key.view(np.int64))


def _bucket_cases():
    rng = np.random.default_rng(201)
    gaps = np.sort(np.concatenate([rng.integers(0, 40, 50),
                                   rng.integers(20_000, 20_100, 300),
                                   rng.integers(3 << 20, (3 << 20) + 9, 80)]))
    return {
        "both ends empty": (8, 16, 0, np.sort(rng.integers(3 << 12, 5 << 12,
                                                           700))),
        "long gaps": (11, 22, 0, gaps),
        "one bucket": (8, 16, 0, np.full(500, 12_345)),
        "one bucket, shift": (14, 12, 8, np.full(400, 1_000_000)),
        "shift, clamped": (14, 16, 8, np.sort(rng.integers(0, 1 << 28,
                                                          200_000))),
        "two words": (20, 24, 8, np.sort(rng.integers(1 << 20, 1 << 31,
                                                      300_000))),
        "K = 32": (32, 20, 12, np.sort(rng.integers(0, 1 << 32, 300_000,
                                                    dtype=np.uint64))),
        "no rows": (8, 10, 0, np.zeros(0, np.int64)),
    }


@pytest.mark.parametrize("case", sorted(_bucket_cases()))
def test_bucket_kernel_equals_plain(cuda, case):
    """The bucket-start kernel (csrc/buckets.cu) == its plain version on
    the card and the CPU route: empty buckets at both ends, gaps wider than
    a warp, one bucket holding every row, shifts, clamps, two-word keys, no
    rows; with slab bases and pads (every real-row count); one launch
    each; the largest bucket equal."""
    k, bbits, shift, w0 = _bucket_cases()[case]
    refk = _bucket_case(w0, k, 202).to(cuda)
    n = refk.numel()
    for base, real in ((0, None), (int(w0[0]) >> shift if n else 0, n // 2),
                       (0, 0), (0, n + 5)):
        want = seed_mode.bucket_starts_plain(refk, k, bbits, shift, base,
                                             real)
        before = seed_mode.bucket_starts.launches
        got = seed_mode.bucket_starts(refk, k, bbits, shift, base, real)
        torch.cuda.synchronize()
        assert seed_mode.bucket_starts.launches == before + 1
        assert got.dtype == torch.int32 and got.numel() == (1 << bbits) + 1
        assert torch.equal(got, want), (base, real)
        assert torch.equal(got.cpu(), seed_mode.bucket_starts(
            refk.cpu(), k, bbits, shift, base, real))
        assert seed_mode.bucket_probes(k, 1, got) == seed_mode.bucket_probes(
            k, 1, want)


@pytest.mark.parametrize("case", sorted(_bucket_cases()))
def test_bucket_kernel_alignment(cuda, case):
    """The bucket-start kernel == its plain version and == searchsorted of
    the rows' prefixes over every bucket, with the rows as views at 8-byte
    offsets 0 and 1 (the warp steps' origin) and the table written into
    ``out`` rows at 4-byte offsets 0..3 of a larger buffer (the 16-byte
    stores' ragged ends), with and without pads."""
    k, bbits, shift, w0 = _bucket_cases()[case]
    keys = _bucket_case(w0, k, 212).to(cuda)
    n, nb = keys.numel(), 1 << bbits
    ar = torch.arange(nb + 1, dtype=torch.int64, device=cuda)
    for o in (0, 1):
        big = torch.empty(n + 2, dtype=torch.int64, device=cuda)
        refk = big[o:o + n]
        refk.copy_(keys)
        for real in (n, n // 3):
            want = seed_mode.bucket_starts_plain(refk, k, bbits, shift, 0,
                                                 real)
            rel = seed_mode._key_word0(refk, k).clone()
            rel[real:] = seed_mode._PAD_WORD0
            pref = (rel >> shift).clamp(max=nb - 1)
            lib = torch.searchsorted(pref, ar, side="left").to(torch.int32)
            assert torch.equal(lib, want), (o, real)
            for a in range(4):
                buf = torch.full((nb + 5,), -9, dtype=torch.int32,
                                 device=cuda)
                out = buf[a:a + nb + 1]
                got = seed_mode.bucket_starts(refk, k, bbits, shift, 0, real,
                                              out)
                torch.cuda.synchronize()
                assert got.data_ptr() == out.data_ptr()
                assert torch.equal(out, want), (o, real, a)
                assert (buf[:a] == -9).all(), (o, real, a)
                assert (buf[a + nb + 1:] == -9).all(), (o, real, a)


@pytest.mark.parametrize("k", range(1, 33))
def test_bucket_tables_equal_plain(cuda, k):
    """At every K, bucket_table's and the slab tables' parameters on a
    real index: kernel == plain, the largest bucket equal."""
    idx = build_index(_table_text(60_001, 203), device=cuda)
    refk, _ = seed_mode.seed_table(idx, k)
    word0_bits = 2 * min(k, 16)
    bbits = min(word0_bits, 22)
    for shift in sorted({word0_bits - bbits, max(0, word0_bits - 16)}):
        got = seed_mode.bucket_starts(refk, k, bbits, shift)
        want = seed_mode._build_bucket_table(seed_mode._key_word0(refk, k),
                                             bbits, shift)
        assert torch.equal(got, want[0]), shift
        assert int((got[1:] - got[:-1]).max()) == want[1]
    slab, shift = -(-idx.n // 8), max(0, word0_bits - 16)
    for i in range(8):
        rows = refk[i * slab:(i + 1) * slab]
        base = int(seed_mode._key_word0(rows[:1], k)) >> shift
        got = seed_mode.bucket_starts(rows, k, 16, shift, base,
                                      idx.n - i * slab)
        want = seed_mode.bucket_starts_plain(rows, k, 16, shift, base,
                                             idx.n - i * slab)
        assert torch.equal(got, want), i


def test_table_kernels_on_cuda_never_take_the_plain_path(cuda, monkeypatch):
    """With every plain table function made to fail, card queries still
    run: a default call (its plan builds the bucket table), a join call on
    the cached tables and the 3-slab program; each table kernel launched
    once per table built, the key pack once per call."""
    def plain(*args, **kwargs):
        raise AssertionError("a plain table path ran on CUDA tensors")

    ref = with_n_runs(random_genome(200_000, seed=204), 3, 40, seed=205)
    qry = with_n_runs(mutate(ref, 0.01, 0.001, seed=206), 2, 30, seed=207)
    want = find_seed_matches(build_index(ref, device="cpu"), qry,
                             Config(min_length=20))
    for name in ("packed_key_words_plain", "seed_table_rows_plain",
                 "bucket_starts_plain", "_build_bucket_table"):
        monkeypatch.setattr(seed_mode, name, plain)
    idx = build_index(ref, device=cuda)
    counts = (seed_mode.seed_table_rows, seed_mode.bucket_starts,
              seed_mode.packed_key_words)
    before = [f.launches for f in counts]
    got = find_seed_matches(idx, qry, Config(min_length=20))
    assert [f.launches - b for f, b in zip(counts, before)] == [1, 1, 1]
    assert _tuples(got) == _tuples(want)
    find_seed_matches(idx, qry, Config(min_length=20, frontend="join"))
    assert [f.launches - b for f, b in zip(counts, before)] == [1, 1, 2]
    find_seed_matches_sharded(idx, qry, Config(min_length=20), n_slabs=3)
    assert [f.launches - b for f, b in zip(counts, before)] == [1, 4, 3]


def test_failed_table_kernel_build_raises(cuda, monkeypatch, tmp_path):
    """A source nvcc refuses raises on CUDA tensors, with the compiler's
    message; nothing falls back to the plain versions."""
    from slamem_tpu_torch.kernels import buckets, seedkeys

    broken = tmp_path / "broken.cu"
    broken.write_text("extern \"C\" int f() { return not_declared; }\n")
    text = torch.zeros(100, dtype=torch.uint8, device=cuda)
    sa = torch.arange(100, dtype=torch.int32, device=cuda)
    calls = {seedkeys: [lambda: seed_mode.seed_table_rows(text, sa, 8),
                        lambda: seed_mode.packed_key_words(text, 8, 2)],
             buckets: [lambda: seed_mode.bucket_starts(sa.to(torch.int64), 8,
                                                       16, 0)]}
    try:
        for module, fns in calls.items():
            monkeypatch.setattr(module, "_SOURCE", broken)
            module.load_kernel.cache_clear()
            for fn in fns:
                with pytest.raises(RuntimeError, match="not_declared"):
                    fn()
    finally:
        monkeypatch.undo()
        seedkeys.load_kernel.cache_clear()
        buckets.load_kernel.cache_clear()


def test_cli_save_load_on_cuda(cuda, tmp_path):
    """-save and -load on the card: an index loaded for "-device cuda"
    (its tensors on cuda:0) is on the device the run asked for."""
    ref = random_genome(20_000, seed=157)
    rp, qp = str(tmp_path / "r.fa"), str(tmp_path / "q.fa")
    write_fasta(rp, [Sequence("r", ref)])
    write_fasta(qp, [Sequence("q", mutate(ref, 0.01, 0.001, seed=158))])
    npz = str(tmp_path / "i.npz")
    outs = []
    for extra in ([], ["-save", npz], ["-load", npz]):
        o = str(tmp_path / f"o{len(outs)}.txt")
        assert main([*extra, "-device", "cuda", "-o", o, rp, qp]) == 0
        outs.append(open(o, "rb").read())
    assert outs[0] == outs[1] == outs[2] and outs[0].count(b"\n") > 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL group in this process, destroyed afterwards."""
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        yield make_mesh(1, cuda)
    finally:
        dist.destroy_process_group()


def _tuples(m):
    return sorted(zip(m.refpos.tolist(), m.qpos.tolist(), m.length.tolist()))


@pytest.mark.parametrize("fields", [dict(min_length=20),
                                    dict(min_length=20, sparse_seeds="off"),
                                    dict(min_length=20, pair_capacity=4096)])
def test_one_rank_nccl_mesh_branches_equal_single_device(nccl_mesh, fields):
    """The replicated engine given a one-rank NCCL group on the card and
    the one-slab-per-rank mesh branch, their gathers and reductions over
    that group, list the single-device engine's matches (~200 kbp; dense,
    sparse, several rounds)."""
    assert nccl_mesh.group is not None and nccl_mesh.device.type == "cuda"
    ref = with_n_runs(random_genome(200_000, seed=153), 3, 40, seed=154)
    qry = with_n_runs(mutate(ref, 0.01, 0.001, seed=155), 2, 30, seed=156)
    idx = build_index(ref, device=nccl_mesh.device)
    cfg = Config(**fields)
    want = _tuples(find_seed_matches(idx, qry, cfg))
    assert len(want) > 0
    for fn in (find_seed_matches, find_seed_matches_sharded_mesh):
        got = fn(idx, qry, cfg, nccl_mesh)
        assert _tuples(got) == want, fn.__name__
        assert "gather" in got.stats["stage_s"]


def test_cli_launcher_variables_put_rank0_on_cuda0(cuda, tmp_path):
    """-device cuda under the launcher variables (one process): the CLI
    joins a one-rank NCCL group on cuda:0 and lists what a plain run lists,
    with and without -shard."""
    ref = random_genome(50_000, seed=180)
    rp, qp = str(tmp_path / "r.fa"), str(tmp_path / "q.fa")
    write_fasta(rp, [Sequence("r", ref)])
    write_fasta(qp, [Sequence("q", mutate(ref, 0.01, 0.001, seed=181))])
    plain = str(tmp_path / "plain.txt")
    assert main(["-device", "cuda", "-o", plain, rp, qp]) == 0
    env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:"
               f"{_free_port()}", JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0",
               PYTHONPATH=REPO)
    for flags in ([], ["-shard"]):
        out = str(tmp_path / "mesh.txt")
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, torch.distributed as dist\n"
             "from slamem_tpu_torch.cli.main import main\n"
             "rc = main(sys.argv[1:])\n"
             "assert dist.get_backend() == 'nccl'\n"
             "dist.destroy_process_group()\n"
             "sys.exit(rc)\n",
             *flags, "-device", "cuda", "-v", "-o", out, rp, qp],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "device: cuda:0" in proc.stderr
        assert open(out, "rb").read() == open(plain, "rb").read()

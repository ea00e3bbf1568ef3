"""Port vs JAX package: FM-index build, LCP array, npz format, synth.

Same inputs (numpy, from seeds) go through ``slamem_tpu`` and
``slamem_tpu_torch`` on the CPU. Tolerance: exact — every compared array is
integer and must be equal bit for bit (the suffix array is unique under the
order contract, so SA, BWT, occ checkpoints, C[] and LCP are determined).
"""

import numpy as np
import pytest
import torch

from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.index.lcp import lcp_adjacent as jax_lcp
from slamem_tpu.index.serialize import load_index as jax_load
from slamem_tpu.index.serialize import save_index as jax_save
from slamem_tpu.io import FastaSet
from slamem_tpu.utils import synth as jax_synth

from slamem_tpu_torch.index.build import build_index
from slamem_tpu_torch.index.lcp import lcp_adjacent
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
    _assert_same_index(jidx, load_index(str(tmp_path / "j.npz"), "cpu"))
    save_index(str(tmp_path / "t.npz"), tidx)
    _assert_same_index(jax_load(str(tmp_path / "t.npz")), tidx)
    _assert_same_index(jidx, load_index(str(tmp_path / "t.npz"), "cpu"))


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
        load_index(str(tmp_path / "v2.npz"), "cpu")


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

"""Port vs JAX package: the interleaved rank table and occ queries.

The Pallas kernel runs as the JAX package's own tests run it on the CPU
(``interpret=True``); the port's ``rank_rows`` takes its plain version for
CPU tensors. Tolerance: exact — tables and counts are integers and must be
equal bit for bit. The CUDA kernel itself is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.index.build import rank_batch as jax_rank_batch
from slamem_tpu.kernels.rank import interleaved_rows as jax_rows
from slamem_tpu.kernels.rank import rank_pallas, rank_rows_xla
from slamem_tpu.utils.synth import random_genome, with_n_runs

from slamem_tpu_torch.index.build import build_index, rank_batch
from slamem_tpu_torch.kernels import rank

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)


def _pair(t, occ_block=128):
    return jax_build(t, occ_block=occ_block), build_index(t, occ_block,
                                                          device="cpu")


@pytest.mark.parametrize("n", [300, 495, 496, 991, 5000])
def test_interleaved_table_equals_jax(n):
    t = with_n_runs(random_genome(n, seed=n), 2, 10, seed=n + 1)
    jidx, tidx = _pair(t)
    want = np.asarray(jax_rows(jidx))
    got = rank.interleaved_rows(tidx)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert np.array_equal(want, got.numpy())
    assert rank.interleaved_rows(tidx) is got  # built once per index


def _queries(seed, b, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, size=b).astype(np.int32),
            rng.integers(0, n + 1, size=b).astype(np.int32))


def test_rank_equals_pallas_interpret_and_rank_batch():
    # the inputs of tests/test_rank_kernel.py::test_rank_pallas_matches_reference
    rng_t = with_n_runs(random_genome(5000, seed=141), 3, 40, seed=142)
    jidx, tidx = _pair(rng_t)
    chars, pos = _queries(140, 500, jidx.n)
    want = np.asarray(rank_pallas(jidx, jnp.asarray(chars), jnp.asarray(pos),
                                  interpret=True))
    assert np.array_equal(want, np.asarray(
        jax_rank_batch(jidx, jnp.asarray(chars), jnp.asarray(pos))))
    rows = rank.interleaved_rows(tidx)
    c, p = torch.from_numpy(chars), torch.from_numpy(pos)
    assert np.array_equal(want, rank.rank_rows(rows, c, p).numpy())
    assert np.array_equal(want, rank.rank_rows_plain(rows, c, p).numpy())
    assert np.array_equal(want, rank_batch(tidx, c, p).numpy())


@pytest.mark.parametrize("occ_block", [16, 128])
def test_rank_edges(occ_block):
    t = random_genome(1200, seed=143)
    jidx, tidx = _pair(t, occ_block)
    n = jidx.n
    edge = np.array([0, 1, 127, 128, 129, 495, 496, 497, 991, 992, n - 1, n],
                    np.int32)
    pos = np.repeat(edge, 4)
    chars = np.tile(np.arange(4, dtype=np.int32), edge.size)
    want = np.asarray(jax_rank_batch(jidx, jnp.asarray(chars),
                                     jnp.asarray(pos)))
    assert np.array_equal(want, np.asarray(rank_rows_xla(
        jax_rows(jidx), jnp.asarray(chars), jnp.asarray(pos))))
    c, p = torch.from_numpy(chars), torch.from_numpy(pos)
    assert np.array_equal(want, rank.rank_rows(
        rank.interleaved_rows(tidx), c, p).numpy())
    assert np.array_equal(want, rank_batch(tidx, c, p).numpy())


def test_rank_rows_rejects_bad_arguments():
    tidx = build_index(random_genome(1000, seed=144), device="cpu")
    rows = rank.interleaved_rows(tidx)
    c = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    p = torch.tensor([0, 5, 600, tidx.n], dtype=torch.int32)
    assert rank.rank_rows(rows, c, p).shape == (4,)
    span = rows.shape[0] * rank.SYMS_PER_ROW
    bad = [
        (rows.to(torch.int64), c, p),                   # table dtype
        (rows[:, :64].contiguous(), c, p),              # table width
        (rows, c.to(torch.int64), p),                   # chars dtype
        (rows, c, p.to(torch.int64)),                   # positions dtype
        (rows, c.view(2, 2), p.view(2, 2)),             # not 1-D
        (rows, c[:3], p),                               # shapes differ
        (rows, c, torch.tensor([0, 5, -1, 7], dtype=torch.int32)),
        (rows, c, torch.tensor([0, 5, span, 7], dtype=torch.int32)),
        (rows, torch.tensor([0, 4, 1, 1], dtype=torch.int32), p),
        (rows, torch.tensor([0, -1, 1, 1], dtype=torch.int32), p),
        (rows, (torch.arange(8, dtype=torch.int32) % 4)[::2], p),  # strided
    ]
    for args in bad:
        with pytest.raises(ValueError):
            rank.rank_rows(*args)


def test_module_import_needs_no_nvcc(tmp_path):
    """Importing the kernel module builds nothing and needs no toolkit;
    CPU tensors never touch the kernel library."""
    code = (
        "import torch\n"
        "from slamem_tpu_torch.kernels import rank\n"
        "from slamem_tpu_torch.engine import scan_mode, run\n"
        "rows = rank._build_rows(torch.zeros(10, dtype=torch.uint8))\n"
        "z = torch.zeros(3, dtype=torch.int32)\n"
        "assert rank.rank_rows(rows, z, z).tolist() == [0, 0, 0]\n"
        "assert rank.load_kernel.cache_info().currsize == 0\n"
        "assert rank.rank_rows.launches == 0\n"
        "import sys; assert 'jax' not in sys.modules\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__)),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

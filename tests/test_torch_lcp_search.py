"""Port vs JAX package: LCP pyramid and PSV/NSV/expand/parent_depth.

Same LCP arrays and queries (numpy, from seeds) go through both packages on
the CPU. Tolerance: exact — every answer is an integer index or depth and
must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.index.lcp import lcp_adjacent as jax_lcp
from slamem_tpu.kernels import lcp_search as jls
from slamem_tpu.utils.synth import random_genome, with_repeats

from slamem_tpu_torch.kernels import lcp_search as tls

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)


def _lcp(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "index":  # a real LCP array with deep repeats
        idx = jax_build(with_repeats(random_genome(6000, seed=seed), 5, 400,
                                     seed=seed + 1))
        return np.array(jax_lcp(idx.text, idx.sa))
    n = {"small": 90, "two_levels": 700, "three_levels": 20_000}[kind]
    lcp = rng.integers(0, 12, size=n).astype(np.int32)
    lcp[0] = 0
    return lcp


@pytest.mark.parametrize("kind", ["small", "two_levels", "three_levels",
                                  "index"])
def test_pyramid_queries_equal_jax(kind):
    lcp = _lcp(kind, 61)
    n = lcp.size
    jp = jls.LcpPyramid.build(jnp.asarray(lcp))
    tp = tls.LcpPyramid.build(torch.from_numpy(lcp))
    assert tp.n == jp.n and len(tp.levels) == len(jp.levels)
    for a, b in zip(jp.levels, tp.levels):
        assert np.array_equal(np.asarray(a), b.numpy())

    rng = np.random.default_rng(62)
    b = 512
    j = rng.integers(0, n + 1, size=b).astype(np.int32)
    v = rng.integers(0, 14, size=b).astype(np.int32)
    j[:4] = [0, n, 1, n - 1]
    J, V = jnp.asarray(j), jnp.asarray(v)
    tj, tv = torch.from_numpy(j), torch.from_numpy(v)
    assert np.array_equal(np.asarray(jls.psv(jp, J, V)),
                          tls.psv(tp, tj, tv).numpy())
    assert np.array_equal(np.asarray(jls.nsv(jp, J, V)),
                          tls.nsv(tp, tj, tv).numpy())

    lo = np.minimum(j, rng.integers(0, n + 1, size=b)).astype(np.int32)
    hi = np.maximum(j, lo).astype(np.int32)
    jl, jh = jls.expand(jp, jnp.asarray(lo), jnp.asarray(hi), V)
    tl, th = tls.expand(tp, torch.from_numpy(lo), torch.from_numpy(hi), tv)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert np.array_equal(np.asarray(jh), th.numpy())
    assert np.array_equal(
        np.asarray(jls.parent_depth(jp, jnp.asarray(lo), jnp.asarray(hi))),
        tls.parent_depth(tp, torch.from_numpy(lo), torch.from_numpy(hi))
        .numpy())

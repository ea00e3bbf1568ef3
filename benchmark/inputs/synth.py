"""Synthetic genomes from a seed, in a few large torch calls.

The recipes of ``slamem_tpu_torch/utils/synth.py`` (uniform random bases;
substitutions that always change the base; half deletions, half
insertions, each of 1-9 bases, at distinct cut points), vectorised so that
a 250 Mbp pair takes a fraction of a second on the card. The arrays are
not that module's: the random streams differ, and overlapping deletions
merge here where the loop there may re-emit bases.

Codes: A=0 C=1 G=2 T=3. Every stream is a ``torch.Generator`` on the
target device, seeded from (run seed, stream number), so one seed gives
the same arrays on every run on the same kind of device.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """The generator of one input stream of a run."""
    state = np.random.SeedSequence([seed % 2**64, stream]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) | int(state[1]) << 32)
    return gen


def random_genome(n: int, gen: torch.Generator) -> torch.Tensor:
    """n uniform random bases (uint8 codes 0..3) on the generator's device."""
    return torch.randint(0, 4, (n,), generator=gen, device=gen.device,
                         dtype=torch.uint8)


def mutate(codes: torch.Tensor, sub_rate: float, indel_rate: float,
           gen: torch.Generator) -> torch.Tensor:
    """A diverged copy: int(n * sub_rate) substitutions and int(n *
    indel_rate) indels at distinct positions, each indel a deletion of
    1-9 bases from its cut or an insertion of 1-9 random bases before it,
    with equal odds."""
    dev = codes.device
    n = codes.numel()
    n_sub, n_indel = int(n * sub_rate), int(n * indel_rate)
    perm = torch.randperm(n, generator=gen, device=dev)
    sub = perm[:n_sub]
    cut = perm[n_sub:n_sub + n_indel]
    del perm
    out = codes.clone()
    shift = torch.randint(1, 4, (n_sub,), generator=gen, device=dev,
                          dtype=torch.uint8)
    out[sub] = (out[sub] + shift) % 4
    is_del = torch.rand(n_indel, generator=gen, device=dev) < 0.5
    span = torch.randint(1, 10, (n_indel,), generator=gen, device=dev)
    # deletions: +1 at each cut, -1 past its span; kept where the sum is 0
    depth = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    dcut = cut[is_del]
    depth.index_add_(0, dcut, torch.ones_like(dcut, dtype=torch.int32))
    depth.index_add_(0, (dcut + span[is_del]).clamp(max=n),
                     torch.full_like(dcut, -1, dtype=torch.int32))
    keep = torch.cumsum(depth[:n], 0, dtype=torch.int32) == 0
    del depth
    # insertions: span[i] random bases before position cut[i]
    ins = torch.zeros(n, dtype=torch.int32, device=dev)
    ins[cut[~is_del]] = span[~is_del].to(torch.int32)
    emit = keep.to(torch.int32) + ins
    end = torch.cumsum(emit, 0, dtype=torch.int64)
    total = int(end[-1]) if n else 0
    new = torch.randint(0, 4, (total,), generator=gen, device=dev,
                        dtype=torch.uint8)
    kept = keep.nonzero().squeeze(1)
    # a kept base is the last slot of its position's emission
    new[end[kept] - 1] = out[kept]
    return new

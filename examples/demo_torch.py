#!/usr/bin/env python
"""Worked example of the PyTorch + CUDA port: build an index, find MEMs,
save and load the index, and run the sharded (virtual-slab) engine.

The twin of examples/demo.py, through the port's names: every entry point
runs on the CUDA card when it is not told otherwise, so this needs one.

Run:  PYTHONPATH=. python examples/demo_torch.py    (from the repo root)
"""

import numpy as np

from slamem_tpu_torch.config import Config, MatchMode
from slamem_tpu_torch.engine.run import run_engine
from slamem_tpu_torch.io import FastaSet
from slamem_tpu_torch.report.format import format_matches
from slamem_tpu_torch.utils.synth import mutate, random_genome


def make_set(arrs, names):
    lengths = np.array([len(a) for a in arrs], dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
    return FastaSet(names=names, starts=starts, lengths=lengths,
                    codes=np.concatenate(arrs))


def main():
    # a 200 kbp "reference strain" and two diverged "query strains"
    ref = random_genome(200_000, seed=1)
    ref_set = make_set([ref], ["K12_synthetic"])
    q_set = make_set(
        [mutate(ref, 0.015, 0.0015, seed=2), mutate(ref, 0.03, 0.003, seed=3)],
        ["strainA", "strainB"])

    cfg = Config(mode=MatchMode.MEM, min_length=25, both_strands=True,
                 verbose=True)
    out = run_engine(ref_set, q_set, cfg)

    listing = format_matches(out)
    print(listing[:600])
    print(f"... {out.stats['matches']} matches, "
          f"{out.stats['query_mbp_per_s']:.2f} Mbp/s query throughput")

    # --- index checkpointing: build once, -save/-load across processes ---
    import tempfile

    from slamem_tpu_torch.index.build import build_index
    from slamem_tpu_torch.index.serialize import load_index, save_index

    rtext, _ = ref_set.with_separators()
    index = build_index(rtext)
    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/ref.npz"
        save_index(path, index)
        index2 = load_index(path)
    out2 = run_engine(ref_set, q_set, cfg, index=index2)
    assert out2.stats["matches"] == out.stats["matches"]
    print(f"index save/load roundtrip: {out2.stats['matches']} matches "
          f"(identical)")

    # --- sharded index (BASELINE config #5): the same request over the
    # multi-slab program — one card iterates 4 SA-rank slabs ---
    cfg_sh = Config(mode=MatchMode.MEM, min_length=25, both_strands=True,
                    shard_index=True, shard_slabs=4)
    out3 = run_engine(ref_set, q_set, cfg_sh, index=index2)
    assert format_matches(out3) == listing
    print("sharded (4 virtual slabs): byte-identical listing")


if __name__ == "__main__":
    main()

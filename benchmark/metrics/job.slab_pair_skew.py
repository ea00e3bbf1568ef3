"""The slab program's pair skew, x: the largest slab's candidate pairs
over the mean of the slabs' (``worst_slab_pairs`` over ``pairs`` / the
``slab_tables`` span's ``slabs``), mean per job. 1 is an even split; the
worst slab sets the pace of each round. None where no job logged an
expansion with pairs."""

from benchmark.harness.arith import mean


def _skew(answer) -> float | None:
    by = {}
    for p in answer.phases:
        by.setdefault(p["phase"], p)   # the first record of each span
    tables, expand = by.get("slab_tables"), by.get("slab_expand")
    if tables is None or expand is None or expand["pairs"] <= 0:
        return None
    return expand["worst_slab_pairs"] * tables["slabs"] / expand["pairs"]


def read(run):
    skews = [s for s in map(_skew, run.answers) if s is not None]
    return mean(skews)

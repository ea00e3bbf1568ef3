"""Brute-force ground truth (port of ``slamem_tpu/oracle``)."""

from slamem_tpu_torch.oracle.naive import (  # noqa: F401
    count_occurrences,
    filter_mode,
    find_mems_codes,
    oracle_matches,
)

"""Phase log (port of ``slamem_tpu/utils/log.py``).

Records timed phases with derived throughput (Mbp/s; on the card, achieved
GB/s and its share of the card's memory rate) and prints each one as it
ends: a ``[slamem] <phase>: <s>s key=value ...`` line on stderr, or one
JSON object per line with ``SLAMEM_LOG_JSON=1``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager

# NVIDIA H100 SXM5 80GB HBM3 device memory rate (NVIDIA data sheet), GB/s:
# the roofline the achieved rate is a share of
H100_HBM_GBPS = 3350.0


class PhaseLog:
    """``device_rates``: the phases ran on the card, so a ``bytes`` field
    gives the achieved GB/s and its share of H100_HBM_GBPS (a CPU run's
    bytes over seconds is no device rate, so it is not derived)."""

    def __init__(self, enabled: bool = True, device_rates: bool = False):
        self.enabled = enabled
        self.device_rates = device_rates
        self.json_mode = os.environ.get("SLAMEM_LOG_JSON") == "1"
        self.records: list[dict] = []

    @contextmanager
    def phase(self, name: str, **fields):
        """Time a phase. Yields the mutable field dict so callers can attach
        values known only at its end (bytes touched, pair counts); the
        derived rates come from the final fields."""
        t0 = time.perf_counter()
        try:
            yield fields
        finally:
            dt = time.perf_counter() - t0
            rec = {"phase": name, "seconds": round(dt, 6), **fields}
            if "bp" in fields and dt > 0:
                rec["mbp_per_s"] = round(fields["bp"] / 1e6 / dt, 3)
            if self.device_rates and "bytes" in fields and dt > 0:
                gbps = fields["bytes"] / 1e9 / dt
                rec["gb_per_s"] = round(gbps, 2)
                rec["hbm_fraction"] = round(gbps / H100_HBM_GBPS, 4)
            self.records.append(rec)
            if self.enabled:
                self.emit(rec)

    def emit(self, rec: dict) -> None:
        if self.json_mode:
            print(json.dumps(rec), file=sys.stderr)
        else:
            extra = " ".join(f"{k}={v}" for k, v in rec.items()
                             if k not in ("phase", "seconds"))
            print(f"[slamem] {rec['phase']}: {rec['seconds']:.3f}s {extra}",
                  file=sys.stderr)


NULL_LOG = PhaseLog(enabled=False)

"""The control of the benchmark's check, at a configuration's own size.

    python3 benchmark/control.py --config <name> --seeds <n> [<n> ...] \
        [--device cuda|cpu]

For each seed: the configuration's inputs, the reference's listing, and
the control's: the same reference at one more than its stride, which
breaks the configuration's guarantee (every MEM of length >= L). The
control's listing is judged as a run's answer is (``harness.checks``),
and must come out wrong. Prints one JSON line a seed; exits 1 if the
control passed on any seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark.harness import checks  # noqa: E402
from benchmark.harness.manifest import load_manifest  # noqa: E402
from benchmark.inputs.build import make_inputs  # noqa: E402
from benchmark.reference.listing import expected_listing  # noqa: E402
from benchmark.reference.mems import seed_plan  # noqa: E402


def control_readings(config: dict, seed: int, device: torch.device) -> dict:
    """The compared numbers of the control's listing, and the counts."""
    inp = make_inputs(config, seed, device)
    min_len = int(config["min_length"])
    args = (inp.ref_names, inp.refs, inp.query_names, inp.queries, min_len,
            device)
    t0 = time.perf_counter()
    want, n_want = expected_listing(*args)
    t1 = time.perf_counter()
    got, n_got = expected_listing(*args, stride=seed_plan(min_len)[1] + 1)
    numbers, _ = checks.compare(want, [len(got)], {0: got})
    return {"seed": seed, "mems": n_want, "control_mems": n_got,
            "reference_s": t1 - t0, "numbers": numbers,
            "control_correct": checks.passed(numbers)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    entry = next(c for c in load_manifest()["configs"]
                 if c["name"] == args.config)
    config = json.loads((ROOT / entry["file"]).read_text())
    passed = False
    for seed in args.seeds:
        r = control_readings(config, seed, torch.device(args.device))
        passed |= r["control_correct"]
        print(json.dumps({"config": args.config, **r}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    raise SystemExit(main())

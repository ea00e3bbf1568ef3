"""Run one cell of BENCHMARK.json on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints progress and the compared numbers on
stderr, and as the last line of stdout one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``. Exits 1, with no
result, without enough CUDA cards, and 3 if the run loaded JAX or the JAX
package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / "build" / "cache"


def main(argv=None) -> int:
    # every build and kernel cache stays inside the checkout, at fixed
    # paths (the program builds its own kernels into its build/ dirs)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness.manifest import load_cell

    cell = load_cell(args.workload)
    import torch

    t_torch = time.perf_counter()

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"error: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    from benchmark.harness.runner import ForbiddenImport, run_cell

    try:
        result, numbers = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), torch.device("cuda", 0),
                                   T_START, t_torch)
    except ForbiddenImport as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)   # the checkout: the program and this package
    raise SystemExit(main())

"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the cell's end-to-end metrics (``--trace 0``) or per-layer metrics
(``--trace 1``) as one JSON line, the last of standard output, and the
numbers that decide ``correct`` beside their limits as the last lines of
standard error. Exits non-zero, with no result, without enough CUDA cards,
without the port beside it, or when a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CACHE = BENCH / "cache"
# every build and kernel cache at a fixed place inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
sys.path.insert(0, str(BENCH.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    with open("BENCHMARK.json") as f:
        spec = json.load(f)
    chips = {w["name"]: int(w["chips"]) for w in spec["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    from portbench import harness

    why = harness.card_check(chips)
    if why is not None:
        print(f"portbench: {why}: no result", file=sys.stderr)
        return 2
    import tpuslam_torch  # noqa: F401  (fails here, before any work, where the port is absent)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), device, T_START)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    harness.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

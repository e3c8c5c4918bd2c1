"""The control of ``correct``: run a cell as run.py does and print, beside
the program's numbers, those of the reference put in the program's place
in bfloat16 (``correct.numbers(control=True)``). Not run by the benchmark's
own runs; run on the card at the cell's size to set and check the limits:

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--fault NAME]

One JSON line per seed: {"seed", "program": {...}, "control": {...}}.
``--fault`` plants one of ``faults.FAULTS`` in the program first, so that
"program" reads that fault.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    with open("BENCHMARK.json") as f:
        spec = json.load(f)
    chips = {w["name"]: int(w["chips"]) for w in spec["workloads"]}[args.workload]
    why = harness.card_check(chips)
    if why is not None:
        print(f"portbench: {why}", file=sys.stderr)
        return 2
    if args.fault:
        from portbench import faults

        faults.plant(args.fault)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        out = harness.run_cell(spec, args.workload, seed, args.seconds, False, device, time.perf_counter(), control=True)
        program = {k: c["value"] for k, c in out["checks"].items()}
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": out["correct"], "program": program, "control": out["control"],
                          "limits": {k: c["limit"] for k, c in out["checks"].items()}, "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

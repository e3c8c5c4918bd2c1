"""Run a cell of BENCHMARK.json on the CPU at a small size, for the tests:

    python portbench/tests/cpu_cell.py <bench dir> <workload> <seconds> [--fault NAME] [--control]

``<bench dir>`` is a copy of ``portbench`` (made by :func:`small_bench`)
whose configurations were cut to fewer sequences and warm-up frames. The
harness runs the port's plain twins on the CPU (no card). ``--fault`` plants
one of ``faults.FAULTS`` in the program's timed path first. Prints the
result's JSON and, last, the top-level names of the forbidden modules
loaded.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))


def small_bench(dst: Path, sequences: int = 1, warm_frames: int = 4) -> dict:
    """A copy of the benchmark under ``dst`` with every configuration cut to
    ``sequences`` sequences and ``warm_frames`` warm-up frames, so that a
    run fits the CPU; the rig, the traffic and the limits stay the cell's
    own. Returns the spec with its configuration files relative to
    ``dst``."""
    shutil.copytree(HERE.parent, dst, ignore=shutil.ignore_patterns("cache", "__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        c["file"] = c["file"].split("/", 1)[1]
    for f in (dst / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update(warm_frames=warm_frames, sequences=min(int(cfg["sequences"]), sequences))
        f.write_text(json.dumps(cfg))
    (dst / "spec.json").write_text(json.dumps(spec))
    return spec


def main(argv) -> int:
    import torch

    from portbench import faults, harness

    torch.set_num_threads(2)  # several of these run at once under the tests
    bench, workload, seconds = Path(argv[0]), argv[1], float(argv[2])
    if "--fault" in argv:
        faults.plant(argv[argv.index("--fault") + 1])
    spec = json.loads((bench / "spec.json").read_text())
    out = harness.run_cell(spec, workload, 2**31 + 11, seconds, False, torch.device("cpu"), T_START,
                           root=bench, bench=bench, control="--control" in argv)
    print(json.dumps(out))
    print(json.dumps(harness.loaded_forbidden()))
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--make":
        small_bench(Path(sys.argv[2]), *map(int, sys.argv[3:]))
    else:
        sys.exit(main(sys.argv[1:]))

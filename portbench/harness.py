"""One run of one cell of ``BENCHMARK.json``, driven by its data.

A cell names a configuration and a traffic mix; the harness finds them by
name:

- ``BENCHMARK.json``'s ``configs`` entry gives the configuration's file
  (``configs/<config>.json``: the rig, the sizes, the guarantees); beside it
  ``configs/<config>.py`` holds ``build(cfg, device)``, which returns a
  driver (``drivers.py``) around the port's entry points;
- ``traffic/<traffic>.json`` holds the stream's parameters (``stream.py``);
- ``metrics/<metric>.py`` holds ``read(rec)`` for each metric, end to end
  and per layer; it returns None where the run gave it nothing to read;
- ``limits/<workload>.json`` holds the limit of each number ``correct``
  compares (``correct.py``).

A run: render the clean frames once per checkout, add the seed's noise,
build the system, warm it up on the stream's first frames, then hand in
frames for ``seconds`` (a closed loop: the next frame as soon as the call
returns), flush and synchronise. On the card every run profiles the window's
first ``TRACE_FRAMES`` calls (the card's kernels alone with ``--trace 0``,
the host's ops too with ``--trace 1``, which also records the hand kernels'
calls there). After the window: the peak memory, the drain, the comparison
with the reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from portbench import correct, stream
from portbench.trace import LaunchRecorder, Profile, breakdown, busy_seconds

HERE = Path(__file__).resolve().parent
TRACE_FRAMES = 16  # calls (one frame of every sequence each) in the profiled span that opens the window
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuslam")  # top-level module names the run may not load


def load_module(path: Path):
    """A module from its file (names may hold dots, so not by import)."""
    spec = importlib.util.spec_from_file_location("portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic, metrics
    and limits, found by name."""

    def __init__(self, spec: dict, name: str, root: Path, bench: Path = HERE):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {', '.join(sorted(cells))})")
        self.workload = cells[name]
        cfg_entry = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        cfg_file = root / cfg_entry["file"]
        self.config = load_json(cfg_file)
        self.builder = load_module(cfg_file.with_suffix(".py"))
        self.bench = bench
        self.traffic = load_json(bench / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{name}.json")
        moves = {m["name"] for m in spec["end_to_end"] if name in m.get("workloads", [name])}
        self.end_to_end = [m for m in spec["end_to_end"] if m["name"] in moves]
        self.per_layer = [
            m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)
        ]

    def readers(self, metrics):
        return {m["name"]: (m, load_module(self.bench / "metrics" / f"{m['name']}.py")) for m in metrics}


def _now() -> float:
    return time.perf_counter()


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             root: Path = Path("."), control: bool = False, bench: Path = HERE) -> Dict:
    """Run one cell once; returns the result line's dict (``checks`` last).
    ``control`` also returns the control's numbers under ``control``."""
    import torch

    cell = Cell(spec, name, root, bench)
    cfg, traffic = cell.config, cell.traffic
    rig = stream.Rig.of(cfg["rig"])
    n_seq = int(cfg["sequences"])
    seqs = stream.streams(traffic, rig, n_seq)
    clean = stream.clean_frames(traffic, rig, n_seq)
    frames = stream.noisy_frames(clean, seed, float(traffic["noise"]), device)
    L = frames.shape[1]
    dt = 1.0 / float(traffic["rate_hz"])

    def frame(j):
        idx = [(j + s.offset) % L for s in seqs]
        return (np.stack([frames[s, i, 0] for s, i in enumerate(idx)]), np.stack([frames[s, i, 1] for s, i in enumerate(idx)]))

    driver = cell.builder.build(cfg, device)
    results = [dict() for _ in range(n_seq)]  # per sequence: j -> (T_cw, ok, ready time)
    handin: Dict[int, float] = {}

    def take(got, now):
        for s, r in got:
            results[s][int(r.frame_idx)] = (np.asarray(r.T_cw, np.float64), r.state.name == "OK", now, r.made_keyframe)

    warm = int(cfg["warm_frames"])
    for j in range(warm):
        got = driver.step(*frame(j), j * dt, j)
        take(got, _now())
    driver.sync()

    is_cuda = device.type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    solves0 = len(driver.solve_ms())
    rec: Dict = {"trace": None, "launches": None, "trace_end": None}
    launches = LaunchRecorder() if trace and is_cuda else None
    prof = Profile(host=trace) if is_cuda else None
    j = warm

    def close_span():
        if launches is not None:
            launches.on = False
        prof.stop()
        rec["trace_end"], rec["trace_frames"] = _now(), (j - warm) * n_seq
        rec["trace_solves"] = len(driver.solve_ms()) - solves0

    if launches is not None:
        launches.__enter__()
        launches.on = True
    if prof is not None:  # the profiled span opens the window
        prof.start()
    driver.record(True)
    t0 = _now()
    rec["setup_s"] = t0 - t_start
    deadline = t0 + seconds
    try:
        while True:
            now = _now()
            if now >= deadline:
                break
            if prof is not None and rec["trace_end"] is None and j - warm >= TRACE_FRAMES:
                close_span()
            handin[j] = _now()
            got = driver.step(*frame(j), j * dt, j)
            take(got, _now())
            j += 1
        got = driver.flush()
        driver.sync()
        t_end = _now()
        take(got, t_end)
        driver.record(False)
        if prof is not None and rec["trace_end"] is None:
            close_span()
    finally:
        if launches is not None:
            launches.__exit__(None, None, None)
    n_in = j - warm
    rec["wall_s"], rec["t_end"] = t_end - t0, t_end
    rec["frames"] = [
        {"seq": s, "j": k, "handin": handin[k], "ready": v[2], "ok": v[1], "keyframe": v[3],
         "traced": rec["trace_end"] is not None and handin[k] < rec["trace_end"]}
        for s, seq in enumerate(results) for k, v in seq.items() if k in handin
    ]
    rec["attempted"] = n_in * n_seq
    rec["solve_ms"] = driver.solve_ms()[solves0:]
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if is_cuda else 0
    if prof is not None:
        rec["trace"] = prof.read()
        rec["launches"] = launches.calls if launches is not None else None

    driver.shutdown()
    run = {
        "frames": [{k: (v[0], v[1]) for k, v in seq.items() if k in handin} for seq in results],
        "attempted": rec["attempted"],
        "ba": driver.ba.windows(),
        "det": dict(driver.det.records),
        "images": frame,
    }
    failed = rec["attempted"] - sum(1 for f in rec["frames"] if f["ok"])
    del driver
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    values = correct.numbers(run, seqs, seed, cfg["ba_lm"], device)
    ok, checks = correct.judge(values, cell.limits)
    out: Dict = {"correct": ok, "attempted": rec["attempted"], "failed": failed}
    readers = cell.readers(cell.per_layer if trace else cell.end_to_end)
    metrics = {}
    for mname, (m, reader) in readers.items():
        v = reader.read(rec)
        if v is not None:
            metrics[mname] = {"value": float(v), "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = {
        "platform": "gpu" if is_cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if is_cuda else "cpu",
        "count": int(cell.workload["chips"]),
        "memory_peak_bytes": memory_peak,
    }
    if trace and rec["trace"] is not None:
        out["device"]["busy_s"] = busy_seconds(rec["trace"])
        out["device"]["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = breakdown(rec["trace"])
        traced = [f for f in rec["frames"] if f["traced"]]
        out["traced_span"] = {"sequence_frames": len(traced), "keyframes": sum(f["keyframe"] for f in traced),
                              "local_ba_solves": rec["trace_solves"]}
    if control:
        out["control"] = correct.numbers(run, seqs, seed, cfg["ba_lm"], device, control=True)
    out["checks"] = checks
    return out


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the run may not load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def card_check(chips: int) -> Optional[str]:
    """Why the run cannot go on (no card, too few), or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards, torch.cuda.device_count() is {torch.cuda.device_count()}"
    return None


def emit(out: Dict) -> None:
    """The checks as the last lines on standard error, then the result as
    the last line on standard output."""
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)

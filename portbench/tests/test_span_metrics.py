"""CPU tests of the readers of the program's spans (portbench/spans.py and
the six metrics that read it) on a synthetic traced run: one batched call
of 8 sequence-frames with nested host spans, host ops that are not the
program's, and device records.

    python -m pytest portbench/tests/test_span_metrics.py -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))

from portbench import harness, spans  # noqa: E402

MS = 1_000_000  # ns

# one batched call: (name, start ms, end ms); a span holds the spans after it that end before it does
CALL = [
    ("facade.track_stereo", 0, 1000),
    ("frontend.upload", 10, 60),
    ("frontend.extract", 60, 200),
    ("frontend.upload", 200, 230),
    ("frontend.extract", 230, 400),
    ("frontend.stereo", 400, 450),
    ("tracking.track_step", 460, 560),
    ("tracking.local_map", 470, 500),
    ("tracking.read_packed", 560, 600),
    ("tracking.resolve", 610, 900),
    ("tracking.keyframe", 620, 890),
    ("local_mapping", 640, 880),
    ("mp.cull", 650, 670),
    ("mp.ba", 680, 860),
    ("local_ba.assemble", 690, 720),
    ("local_ba.solve", 720, 820),
    ("local_ba.apply", 820, 850),
]
OTHER_HOST = [("aten::add", 15, 20), ("cudaLaunchKernel", 905, 906), ("ProfilerStep", 0, 1000)]
DEVICE = [("ccl_tile_kernel", 100, 250), ("gemm", 200, 300), ("getrf", 720, 800), ("Memcpy HtoD", 950, 960)]


def _rec(host=CALL + OTHER_HOST, device=DEVICE, frames=8, t0=5000):
    ns = lambda rows: [(n, (t0 + s) * MS, (t0 + e) * MS) for n, s, e in rows]  # noqa: E731
    return {"trace": {"host": ns(host), "device": ns(device), "syncs": 1, "window_s": 2.0}, "trace_frames": frames}


def _readers():
    return {p.stem: harness.load_module(p) for p in (HERE.parent / "metrics").glob("*.py")}


NEW = (
    "frontend.host_ms_per_frame", "tracking.host_ms_per_frame", "tracking.local_map_builds_per_frame",
    "mapping.self_ms_per_keyframe", "local_ba.assemble_ms", "device.idle_unattributed_pct",
)


def test_self_time_is_the_duration_less_the_direct_childrens():
    got = {sp[0] + str(sp[1] // MS): t / MS for sp, t in spans.self_ns(spans.program_spans(_rec()))}
    assert got["facade.track_stereo5000"] == 1000 - 440 - 100 - 40 - 290
    assert got["tracking.track_step5460"] == 70 and got["tracking.local_map5470"] == 30
    assert got["tracking.resolve5610"] == 20 and got["tracking.keyframe5620"] == 30
    assert got["local_mapping5640"] == 240 - 20 - 180 and got["mp.ba5680"] == 180 - 30 - 100 - 30
    assert got["local_ba.solve5720"] == 100
    assert len(got) == len(CALL)  # the host ops that are not the program's are left out


def test_interval_arithmetic():
    assert spans.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert spans.minus([(0, 10), (20, 30)], [(2, 3), (8, 22), (25, 26), (40, 50)]) == [(0, 2), (3, 8), (22, 25), (26, 30)]
    assert spans.minus([(0, 10)], []) == [(0, 10)] and spans.minus([(0, 10)], [(0, 10)]) == []
    assert spans.total([(0, 2), (5, 8)]) == 5


@pytest.mark.parametrize("name,want", [
    ("frontend.host_ms_per_frame", (50 + 140 + 30 + 170 + 50) / 8),
    ("tracking.host_ms_per_frame", (130 + 70 + 30 + 40 + 20 + 30) / 8),
    ("tracking.local_map_builds_per_frame", 1 / 8),
    ("mapping.self_ms_per_keyframe", 40 + 20 + 20),
    ("local_ba.assemble_ms", 30),
    # idle in the call: 1000 less busy 100-300, 720-800, 950-960; no span below the
    # facade in 0-10, 450-460, 600-610, 900-1000 (less 950-960 busy): 120 of 710
    ("device.idle_unattributed_pct", 100.0 * 120 / 710),
])
def test_each_reader_on_one_call(name, want):
    assert _readers()[name].read(_rec()) == pytest.approx(want, rel=1e-12)


def test_counts_and_medians_over_two_calls():
    """A second call without a local-map rebuild, whose assembly takes 50 ms
    (its solve 80)."""
    longer = {"local_ba.assemble": (690, 740), "local_ba.solve": (740, 820)}
    second = [(n, *longer.get(n, (s, e))) for n, s, e in CALL if n != "tracking.local_map"]
    rec = _rec(host=CALL + [(n, s + 2000, e + 2000) for n, s, e in second], frames=16)
    r = _readers()
    assert r["tracking.local_map_builds_per_frame"].read(rec) == 1 / 16
    assert r["local_ba.assemble_ms"].read(rec) == pytest.approx(40)  # the median of 30 and 50
    assert r["mapping.self_ms_per_keyframe"].read(rec) == pytest.approx(80)


@pytest.mark.parametrize("name", NEW)
def test_no_trace_or_no_program_span_reads_none(name):
    reader = _readers()[name]
    assert reader.read({"trace": None, "trace_frames": 0}) is None
    assert reader.read(_rec(host=OTHER_HOST)) is None  # a program without spans: the parent


def test_the_new_metrics_are_declared_for_the_cell():
    import json

    spec = json.loads((HERE.parent.parent / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = by_name[name]
        assert m["source"] == "program_span" and m["moves"] == "device_ms_per_frame" and m["workloads"] == ["euroc_x8.lap"]
    assert set(NEW) <= set(_readers())

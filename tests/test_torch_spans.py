"""The port's host-stage spans (``tpuslam_torch.spans``) on the CPU.

- Without a profiler and without a timer ``span`` hands out the shared no-op
  and records nothing; with a timer it adds its seconds there.
- Under a CPU ``torch.profiler.profile``, ``MultiTracker.track_stereo`` over
  2 sequences (160x120, a keyframe every frame, a ``LocalMapper`` each) for
  3 frames: every named span is in the trace; each call's ``frontend.*`` and
  ``tracking.*`` spans lie inside its ``facade.track_stereo``; local BA's
  solve lies inside ``mp.ba``, inside ``local_mapping``, inside
  ``tracking.keyframe``; one ``tracking.track_step`` per steady call and one
  ``local_mapping`` per keyframe made; and the mappers' ``StageTimer``
  durations lie within the profiler's intervals of the same spans.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_parity import QVGA, stereo_scene
from tpuslam_torch.backend.mapping import MapperConfig
from tpuslam_torch.frontend.frame import FrontendParams
from tpuslam_torch.frontend.tracking import TrackerConfig
from tpuslam_torch.parallel.multi_seq import MultiTracker
from tpuslam_torch.spans import NO_SPAN, span
from tpuslam_torch.system import StageTimer

CAM = QVGA._replace(fx=QVGA.fx / 2, fy=QVGA.fy / 2, cx=80.0, cy=60.0, width=160, height=120)
FRAMES = 3
NAMES = (
    "facade.track_stereo", "frontend.upload", "frontend.extract", "frontend.stereo", "tracking.local_map",
    "tracking.track_step", "tracking.read_packed", "tracking.resolve", "tracking.keyframe", "local_mapping",
    "mp.fuse_apply", "mp.cull", "mp.fuse_dispatch", "mp.covis", "mp.ba", "mp.kf_cull", "local_ba.assemble",
    "local_ba.solve", "local_ba.apply",
)


def test_span_without_profiler_or_timer_is_the_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    s = span("frontend.extract")
    assert s is NO_SPAN and span("local_mapping") is s
    with s as inner:
        pass
    assert inner is NO_SPAN and not hasattr(inner, "seconds")


def test_span_with_a_timer_adds_its_seconds():
    timer = StageTimer(warmup=0)
    for _ in range(2):
        with span("track", timer) as s:
            sum(range(1000))
    assert timer.counts == {"track": 2} and len(timer.times["track"]) == 2
    assert timer.times["track"][-1] == s.seconds > 0


@pytest.fixture(scope="module")
def traced():
    """The program spans of a profiled 2-sequence run, the results per call
    and the mappers' shared StageTimer."""
    seqs = [stereo_scene(FRAMES, cam=CAM, seed=s)[1] for s in range(2)]
    tcfg = TrackerConfig(max_frames_between_kf=1, frontend=FrontendParams(max_lines=64))
    mt = MultiTracker([CAM, CAM], tcfg, device="cpu", mapper_cfg=MapperConfig())
    timer = StageTimer(warmup=0)
    for tr in mt.trackers:
        tr.on_new_keyframe.__self__.timer = timer
    results = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for f in range(FRAMES):
            steady = sum(tr.last_T_cw is not None for tr in mt.trackers)
            rs = mt.track_stereo(np.stack([q[f][0] for q in seqs]), np.stack([q[f][1] for q in seqs]), [f * 0.05] * 2)
            results.append((steady, rs))
    spans = sorted(
        ((e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events() if e.name() in NAMES),
        key=lambda r: (r[1], -r[2]),
    )
    return dict(spans=spans, results=results, timer=timer)


def _of(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner is not outer


def _parent(spans, s):
    """The innermost program span holding ``s``."""
    holders = [o for o in spans if _inside(s, o)]
    return min(holders, key=lambda o: o[2] - o[1]) if holders else None


def test_every_named_span_is_in_the_trace(traced):
    assert set(NAMES) == {s[0] for s in traced["spans"]}


def test_each_calls_spans_lie_inside_its_facade(traced):
    spans = traced["spans"]
    calls = _of(spans, "facade.track_stereo")
    assert len(calls) == FRAMES
    for s in spans:
        if s[0].startswith(("frontend.", "tracking.")):
            assert sum(_inside(s, c) for c in calls) == 1, s
    for c in calls:
        inside = [s[0] for s in spans if _inside(s, c) and s[0].startswith("frontend.")]
        assert inside == ["frontend.upload", "frontend.extract"] * 2 + ["frontend.stereo"]


def test_local_ba_nests_in_the_mapper_inside_the_keyframe(traced):
    spans = traced["spans"]
    solves = _of(spans, "local_ba.solve")
    assert solves
    for s in solves:
        chain = [s]
        for _ in range(3):
            chain.append(_parent(spans, chain[-1]))
        assert [c[0] for c in chain[1:]] == ["mp.ba", "local_mapping", "tracking.keyframe"], chain
        assert _parent(spans, chain[-1])[0] == "tracking.resolve"
    for s in _of(spans, "local_ba.assemble") + _of(spans, "local_ba.apply"):
        assert _parent(spans, s)[0] == "mp.ba"


def test_one_step_per_steady_call_and_one_mapping_per_keyframe(traced):
    spans, results = traced["spans"], traced["results"]
    steady_calls = sum(1 for steady, _ in results if steady)
    assert steady_calls == FRAMES - 1
    assert len(_of(spans, "tracking.track_step")) == len(_of(spans, "tracking.read_packed")) == steady_calls
    assert len(_of(spans, "tracking.resolve")) == sum(steady for steady, _ in results)
    keyframes = sum(r.made_keyframe for _, rs in results for r in rs)
    assert keyframes == 2 * FRAMES
    assert len(_of(spans, "local_mapping")) == keyframes
    assert len(_of(spans, "tracking.keyframe")) == keyframes - 2  # the two first keyframes come from initialization


def test_timer_durations_lie_within_the_traced_intervals(traced):
    spans, timer = traced["spans"], traced["timer"]
    for name in ("local_mapping", "mp.cull", "mp.ba"):
        events = sorted(_of(spans, name), key=lambda s: s[2])
        seconds = timer.times[name]
        assert len(seconds) == len(events) > 0
        for (_, s, e), dt in zip(events, seconds):
            slack = (e - s) / 1e9 - dt
            assert -50e-6 <= slack <= 5e-3, (name, slack)

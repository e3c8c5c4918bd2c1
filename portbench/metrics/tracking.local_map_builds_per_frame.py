"""The trackers' local-map rebuilds per sequence-frame: the program's
``tracking.local_map`` spans (opened only when a tracker's local map is
rebuilt, not on a cache hit) in the profiled span, over the sequence-frames
handed in during it."""

from portbench.spans import FACADE, named, program_spans


def read(rec):
    spans = program_spans(rec)
    if not spans or not named(spans, FACADE) or not rec.get("trace_frames"):
        return None
    return len(named(spans, "tracking.local_map")) / rec["trace_frames"]

"""The tracking control's host time per sequence-frame (ms): the summed self
time of the program's ``facade.track_stereo`` and ``tracking.*`` spans (the
batched call less its front end, and the step's inputs, its enqueue, the
packed read, the resolves and the keyframe insertions less the mappers) in
the profiled span, over the sequence-frames handed in during it."""

from portbench.spans import FACADE, program_spans, self_ns


def read(rec):
    spans = program_spans(rec)
    if not spans or not rec.get("trace_frames"):
        return None
    own = [t for sp, t in self_ns(spans) if sp[0] == FACADE or sp[0].startswith("tracking.")]
    return sum(own) / 1e6 / rec["trace_frames"] if own else None

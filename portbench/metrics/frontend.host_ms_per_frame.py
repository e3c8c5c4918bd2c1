"""The front end's host time per sequence-frame (ms): the summed duration of
the program's ``frontend.*`` spans (the upload of the stacked frames, each
batched extraction, the batched stereo) in the profiled span, over the
sequence-frames handed in during it."""

from portbench.spans import named, program_spans


def read(rec):
    spans = program_spans(rec)
    if not spans or not rec.get("trace_frames"):
        return None
    front = named(spans, "frontend.")
    return sum(e - s for _, s, e in front) / 1e6 / rec["trace_frames"] if front else None

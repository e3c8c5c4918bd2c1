"""The host's waits for the card in the profiled span (the runtime's
synchronize calls and blocking copies in the trace), per frame handed in
during it (sequence-frames)."""


def read(rec):
    if rec["trace"] is None or not rec.get("trace_frames"):
        return None
    return rec["trace"]["syncs"] / rec["trace_frames"]

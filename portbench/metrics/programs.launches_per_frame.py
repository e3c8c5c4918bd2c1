"""Device kernel records in the profiled span (copies left out), per frame
handed in during it (sequence-frames)."""

from portbench.trace import kernel_records


def read(rec):
    if rec["trace"] is None or not rec.get("trace_frames"):
        return None
    return len(kernel_records(rec["trace"])) / rec["trace_frames"]

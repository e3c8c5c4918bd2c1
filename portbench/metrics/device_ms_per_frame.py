"""The card's kernel time per sequence-frame (ms): the union of the kernel
records' intervals (no copies: a pageable upload's record lasts as long as
the host stages it) over the profiled span that opens the window, divided
by the sequence-frames handed in during it. A fixed number of calls, so the
same work from a seed whatever the host's speed."""

from portbench.trace import busy_intervals, kernel_records


def read(rec):
    if rec["trace"] is None or not rec.get("trace_frames"):
        return None
    busy = busy_intervals(kernel_records(rec["trace"]))
    return sum(e - s for s, e in busy) / 1e6 / rec["trace_frames"]

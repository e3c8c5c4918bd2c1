"""Frames whose pose was resolved in the window, over the window's wall
time (the final flush and synchronisation included); with several
sequences, sequence-frames. Where a span was profiled, the frames handed in
after it over the time from its end to the window's."""


def read(rec):
    t0 = rec["trace_end"] if rec["trace_end"] is not None else rec["t_end"] - rec["wall_s"]
    n = sum(1 for f in rec["frames"] if f["ready"] is not None and not f["traced"])
    return n / (rec["t_end"] - t0) if rec["t_end"] > t0 and n else None

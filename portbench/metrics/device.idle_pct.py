"""Share of the profiled span in which no operation ran on the card (%):
100 x (1 - union of the device records' intervals / span)."""

from portbench.trace import busy_seconds


def read(rec):
    if rec["trace"] is None or rec["trace"]["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(rec["trace"]) / rec["trace"]["window_s"])

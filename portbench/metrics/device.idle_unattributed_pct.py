"""Of the card's idle time inside the program's ``facade.track_stereo``
spans in the profiled span, the share (%) during which no program span
below the facade is open: idle time the program's spans do not name."""

from portbench.spans import FACADE, minus, named, program_spans, total, union
from portbench.trace import busy_intervals


def read(rec):
    spans = program_spans(rec)
    calls = union((s, e) for _, s, e in named(spans or [], FACADE))
    if not calls:
        return None
    idle = minus(calls, busy_intervals(rec["trace"]["device"]))
    below = union((s, e) for n, s, e in spans if n != FACADE)
    return 100.0 * total(minus(idle, below)) / total(idle) if total(idle) > 0 else None

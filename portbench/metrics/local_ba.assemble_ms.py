"""Median duration (ms) of the program's ``local_ba.assemble`` spans in the
profiled span: local BA's host-side assembly of a window (the map's
keyframes, lines and observations gathered into the padded problem)."""

import statistics

from portbench.spans import named, program_spans


def read(rec):
    spans = program_spans(rec)
    ms = [(e - s) / 1e6 for _, s, e in named(spans or [], "local_ba.assemble")]
    return statistics.median(ms) if ms else None

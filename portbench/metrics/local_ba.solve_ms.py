"""Median of the mapper's own solve times (ms) of the local-BA solves that
finished in the window (the solver process's upload to read back, or the
in-process solve)."""

import statistics


def read(rec):
    return statistics.median(rec["solve_ms"]) if rec["solve_ms"] else None

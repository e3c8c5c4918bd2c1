"""Named spans around the port's host stages.

    with span("frontend.extract"):
        feats = batched_extract(imgs, params)
    with span("track", timer) as s:      # timer: system.StageTimer
        r = tracker.track_stereo(left, right, t)
    s.seconds                             # the span's host seconds

Under an active ``torch.profiler`` a span is a range in the profiler's
trace, beside the host's ops and the card's kernels and on their clock, so
that the trace names the host stage during which the card waits. Given a
``timer`` (anything with ``add(stage, seconds)``: the ``StageTimer`` that
``System.timing_summary`` reads) the span adds its host seconds there,
measured inside the trace's range. With neither, :func:`span` returns one
shared object that does nothing. A span launches nothing on the device,
synchronises nothing and reads nothing back.

Names are ``<layer>.<stage>``; ``System``'s stages keep their timer names
(``track``, ``tick``, ``local_mapping``, ``loop_closing``) and the mapper's
are ``mp.*``. The range is a plain host op (``_RecordFunctionFast``), not
``record_function``: under a CUDA trace ``record_function`` also writes a
device-side annotation over the kernels launched inside it, which a reader
of the trace's device records would take for device work.
"""

from __future__ import annotations

import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler


class _Span:
    __slots__ = ("name", "timer", "seconds", "_range", "_t0")

    def __init__(self, name: str, timer):
        self.name = name
        self.timer = timer
        self.seconds = 0.0
        self._range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.timer is not None:
            self.timer.add(self.name, self.seconds)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str, timer=None):
    """A context manager for the host stage ``name``: a range in an active
    profiler's trace, and its seconds added to ``timer`` where given;
    :data:`NO_SPAN` with neither."""
    if timer is None and not _profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(name, timer)

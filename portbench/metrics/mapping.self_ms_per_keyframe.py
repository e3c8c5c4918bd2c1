"""The mapper's own host time per keyframe (ms): the summed self time of the
program's ``local_mapping`` spans and their ``mp.*`` stages (local BA's
``local_ba.*`` spans left out) in the profiled span, over the number of
``local_mapping`` spans there."""

from portbench.spans import named, program_spans, self_ns


def read(rec):
    spans = program_spans(rec)
    if not spans:
        return None
    n = len(named(spans, "local_mapping"))
    own = [t for sp, t in self_ns(spans) if sp[0] == "local_mapping" or sp[0].startswith("mp.")]
    return sum(own) / 1e6 / n if n else None

"""95th percentile of the pose latency over the window's frames (ms), from
the harness's stamps around the facade's calls; in a traced run only the
frames handed in after the profiled span."""

import statistics


def read(rec):
    lat = [f["ready"] - f["handin"] for f in rec["frames"] if f["ready"] is not None and not f["traced"]]
    return 1e3 * statistics.quantiles(lat, n=20)[18] if len(lat) >= 20 else None

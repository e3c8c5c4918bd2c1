"""Mean, over the frames handed in during the window, of the time from a
frame's hand-in until its pose is available to the caller (ms); where a
span was profiled, over the frames handed in after it."""


def read(rec):
    lat = [f["ready"] - f["handin"] for f in rec["frames"] if f["ready"] is not None and not f["traced"]]
    return 1e3 * sum(lat) / len(lat) if lat else None

"""Share of their roofline that the hand kernels reach in the profiled span
(%): the summed least time of their calls (each call's bytes at the HBM
bandwidth, roofline.call_bytes) over their summed device time."""

from portbench import roofline
from portbench.trace import kernel_records


def read(rec):
    if rec["trace"] is None or not rec["launches"]:
        return None
    device_s = sum(e - s for _, s, e in kernel_records(rec["trace"], roofline.HAND_KERNELS)) / 1e9
    bound = roofline.bound_seconds(rec["launches"])
    if bound is None or device_s <= 0:
        return None
    return 100.0 * bound / device_s

"""Process start to the first timed frame (s): rendering or reading the
frames, the seed's noise, building the system, its solver process and
kernel library, and the warm-up frames."""


def read(rec):
    return rec["setup_s"]

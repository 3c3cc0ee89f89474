"""``device_idle_share``: 1 minus the device's busy time (the union of its
operations' intervals on the port's one stream) over the profiled ticks'
wall time, in %."""


def read(run):
    p = run.profile
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])

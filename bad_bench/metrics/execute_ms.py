"""``execute_ms``: host seconds of the benchmark's ``execute`` spans over the
window (``execute_all(None, deliver=True)``: every
plan-group's discovery, join and ``deliver_all``), each span ending in a device synchronisation in
the traced run, over the window's ticks, in ms."""


def read(run):
    if "execute" not in run.spans or not run.window:
        return None
    return 1e3 * run.spans["execute"] / len(run.window)

"""``drain_ms``: host seconds of the benchmark's ``drain`` spans over the
window (``drain_spilled()``: the spill queue's
re-delivery), each span ending in a device synchronisation in
the traced run, over the window's ticks, in ms."""


def read(run):
    if "drain" not in run.spans or not run.window:
        return None
    return 1e3 * run.spans["drain"] / len(run.window)

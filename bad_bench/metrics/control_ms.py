"""``control_ms``: host seconds of the benchmark's ``control`` spans over the
window (the tick's control-plane calls:
``subscribe_bulk``, ``remove_subscriptions``, ``unsubscribe_users``,
``subscribe_users``), each span ending in a device synchronisation in
the traced run, over the window's ticks, in ms."""


def read(run):
    if "control" not in run.spans or not run.window:
        return None
    return 1e3 * run.spans["control"] / len(run.window)

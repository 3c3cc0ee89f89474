"""``ingest_ms``: host seconds of the benchmark's ``ingest`` spans over the
window (``BADEngine.ingest`` of the tick's batch: upload,
``predicate_filter``, BAD-index insert), each span ending in a device synchronisation in
the traced run, over the window's ticks, in ms."""


def read(run):
    if "ingest" not in run.spans or not run.window:
        return None
    return 1e3 * run.spans["ingest"] / len(run.window)

"""``launches_per_tick``: CUDA kernels the profiler saw launched over the
profiled ticks, a tick."""


def read(run):
    p = run.profile
    if not p or not p["kernels"]:
        return None
    return p["kernels"] / p["ticks"]

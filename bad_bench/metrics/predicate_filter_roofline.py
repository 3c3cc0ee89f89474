"""``predicate_filter_roofline``: the kernel's bound over its traced time, in %: the
bytes it must move on the profiled calls' own inputs (``peaks.predicate_filter_bytes``) over the
published 3.35 TB/s, over the summed device time of its launches."""

from bad_bench import peaks, profiling


def read(run):
    p = run.profile
    if not p:
        return None
    t = profiling.kernel_seconds(p, "predicate_filter")
    nbytes = p["bytes"].get("predicate_filter", 0)
    if t <= 0 or not nbytes:
        return None
    return 100.0 * peaks.bound_s(nbytes) / t

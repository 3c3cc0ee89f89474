"""``churn_notify_ms_p90``: the 90th percentile over the window's churn
ticks of the time from handing over the period's batch, once the tick's
control-plane calls have returned, to the closing sync, in ms; churn
cells only. ``notify_ms_p50`` is its median and the cell's end-to-end
metric. The tail is per layer because a 45 s window holds 55-90 churn
ticks, so the p90 rests on the 7-9 ticks beyond it, and the host's slow
stretches of a few seconds move it by 12-22% between runs."""
import numpy as np


def read(run):
    if not run.window or not any(t.control for t in run.window):
        return None
    return 1e3 * float(np.percentile([t.notify_s for t in run.window], 90))

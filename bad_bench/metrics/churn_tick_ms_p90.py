"""``churn_tick_ms_p90``: the 90th percentile of the window's whole churn
ticks, the control-plane calls included, from the first call to the
closing sync, in ms; churn cells only. Per layer because the host's runs
of it spread wider than any bound can hold."""
import numpy as np


def read(run):
    if not run.window or not any(t.control for t in run.window):
        return None
    return 1e3 * float(np.percentile([t.wall_s for t in run.window], 90))

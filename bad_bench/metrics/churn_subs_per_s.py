"""``churn_subs_per_s``: control-plane mutations the engine reported
applied in the window's completed ticks (adds, removes, cohort users in
and out) over the window's seconds; churn cells only. The whole tick's
rate, as a subscriber joining or leaving sees it; per layer because the
host's runs of it spread wider than any bound can hold."""
from bad_bench.system import mutations


def read(run):
    if not run.window or not any(t.control for t in run.window):
        return None
    return mutations(run.window) / run.window_s

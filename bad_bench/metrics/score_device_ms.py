"""``score_device_ms``: device time billed to the program's ``rank`` span
(``enrich.rank_result``: the stage's batched prefill over a plan-group's
candidate slots and the budget's selection) over the profiled ticks, a
tick, in ms; each device operation billed to the innermost program span
open at its launch (``profiling.program``). Scored deployments only."""

# the profiled ticks run with the program's tracer on
PROGRAM_SPANS = True


def read(run):
    p = run.profile
    rank = ((p or {}).get("program") or {}).get("spans", {}).get("rank")
    if not rank or rank["device_s"] <= 0:
        return None
    return 1e3 * rank["device_s"] / p["ticks"]

"""``enrich_mfu``: the model FLOPs of the prompts the enrichment stage
scored in the profiled ticks (the plain scorer's ``flops``, counted from the
configuration at each ``score`` call's (N, S) prompt shape: the
configuration's slots, whatever computes them) over the profiled ticks'
wall time at the card's bf16 peak, in %: the scorer's share of the whole
tick. Scored deployments only."""
from bad_bench import enrichment, peaks


def read(run):
    p, block = run.profile, run.enrichment
    if not p or not block or not run.score_shapes or p["wall_s"] <= 0:
        return None
    plain = enrichment.plain(block)
    model = enrichment.model_settings(block)
    work = sum(plain.flops(model, shape, int(block["lanes"]))
               for shape in run.score_shapes)
    return 100.0 * work / (p["wall_s"] * peaks.BF16_OPS_PER_S)

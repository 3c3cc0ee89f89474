"""Plain scorers of the enrichment stage, one module a model family, found
by the name a configuration's ``enrichment`` block gives under ``plain``.

Each module gives ``init(model, seed, device)``, the weights drawn from the
seed; ``score(weights, tokens, lanes)``, the (N,) float32 scores of a float32
forward with TF32 off; and ``flops(model, shape, lanes)``, the model FLOPs
of scoring prompts of that (N, S) shape. ``model`` is the block's plain
settings with its ``overrides`` applied. The modules import nothing of the
program.
"""

"""PyTorch / CUDA port of the BAD data plane, its enrichment stage and the
dense LMs behind it (the JAX package ``repro`` is the reference it is held
against).

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
see ``repro_torch.device.resolve_device`` for the rule. Kernels written by
hand for Hopper live under ``repro_torch/csrc`` and are built on first use
by ``repro_torch.kernels._build``.
"""

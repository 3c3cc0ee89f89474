"""Benchmark of the PyTorch and CUDA BAD engine (``repro_torch``).

``run.py`` is the command; configurations, cells (traffic mixes) and
per-layer metric readers are found by name under ``configs/``, ``cells/``
and ``metrics/``.
"""

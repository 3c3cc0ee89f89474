"""Per-layer metric readers, one module a metric, found by the metric's
name in ``BENCHMARK.json``. Each has ``read(run)`` (a ``system.Run`` of a
``--trace 1`` run) and returns a number, or None where the run holds
nothing to read."""

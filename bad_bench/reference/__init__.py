"""The plain reference of the benchmark's deployments."""

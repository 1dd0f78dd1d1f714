"""The harness: spec loading, weights, the serving and training windows,
the profiler, the arithmetic of operations and bytes, and the comparison
with the plain references that decides ``correct``."""

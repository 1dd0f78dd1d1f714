"""Plain float32 PyTorch references of the benchmark's configurations.

They import nothing of the port and take nothing it made: the harness hands
them the weights and inputs it drew itself.  ``prec="fp8"`` computes every
matrix product's operands in float8 (e4m3 forward, e5m2 gradients), the
control that a sound comparison has to fail."""

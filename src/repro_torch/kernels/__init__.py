"""Hand-written Hopper kernels of the port, one package per TPU kernel
(``kernel.py`` builds and binds the CUDA source under ``csrc/``, ``ops.py``
is the wrapper the model calls, ``ref.py`` the plain PyTorch version)."""

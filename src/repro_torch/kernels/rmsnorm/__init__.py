"""RMSNorm (optionally of x + residual) for the model's norms: CUDA kernel
(``csrc/rmsnorm.cu``), its binding (``kernel``), the model-layout wrapper
(``ops``) and the plain PyTorch version (``ref``)."""

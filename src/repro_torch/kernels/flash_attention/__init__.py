"""Flash-attention forward for the eager prefill: CUDA kernel
(``csrc/flash_attention.cu``), its binding (``kernel``), the model-layout
wrapper (``ops``) and the plain PyTorch version in the kernel layout
(``ref``)."""

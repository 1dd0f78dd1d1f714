"""Paged attention straight off the block table: CUDA kernel
(``csrc/paged_attention.cu``), its binding (``kernel``), the model-layout
wrapper (``ops``) and the plain PyTorch version (``ref``)."""

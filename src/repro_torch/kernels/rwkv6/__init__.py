"""Chunked RWKV-6 WKV recurrence: CUDA kernel (``csrc/wkv.cu``), its
binding (``kernel``), the model-layout wrapper (``ops``) and the plain
PyTorch version in the kernel layout (``ref``)."""

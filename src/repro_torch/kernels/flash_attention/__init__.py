"""Flash attention for the eager prefill and for training: CUDA forward
(``csrc/flash_attention.cu``, with the rows' logsumexp on request) and
backward (``csrc/flash_attention_bwd.cu``) kernels, their bindings
(``kernel``), the model-layout wrapper and its ``torch.autograd.Function``
(``ops``) and the plain PyTorch versions in the kernel layout (``ref``)."""

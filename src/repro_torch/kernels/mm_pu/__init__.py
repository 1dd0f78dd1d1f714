"""MM PU: a matrix product with f32 accumulation and a fused epilogue
(int8 weight dequant, bias, activation, residual): CUDA kernel
(``csrc/mm_pu.cu``), its binding (``kernel``), the wrapper (``ops``) and the
plain PyTorch version (``ref``)."""

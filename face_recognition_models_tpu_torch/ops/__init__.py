"""Tensor ops of the port: normalisation, image preprocessing, the fused
margin + cross-entropy head and the implicit-GEMM 3x3 conv, with their CUDA
kernels."""

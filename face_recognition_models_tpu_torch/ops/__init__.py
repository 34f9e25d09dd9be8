"""Tensor ops of the port: normalisation, image preprocessing and the fused
margin + cross-entropy head with its CUDA kernels."""

"""PyTorch / CUDA port of face_recognition_models_tpu.

A second package beside the JAX one, with the same module layout. It imports
torch and never JAX; its kernels (the fused margin head, in fp32 and on bf16
tensor cores, and the 3x3 conv) are hand-written CUDA for Hopper (sm_90a)
in `csrc/`. Entry points run on the card (`device="cuda"`)
unless the caller passes `device="cpu"`, and raise when no card is present.
"""

__version__ = "0.1.0"

"""Tensor functions of the port: plain PyTorch versions and the wrappers of
the hand-written CUDA kernels (``csrc/``) that replace the TPU kernels."""

"""PyTorch/CUDA port of flyp_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout module for module; the TPU kernels on the
ported paths are hand-written CUDA kernels under ``csrc/``."""

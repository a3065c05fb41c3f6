"""PyTorch + CUDA port of the SFC int8 fast-convolution stack.

The port mirrors the JAX package module for module and runs its kernels as
hand-written CUDA C++ for Hopper (``csrc/``).  Entry point:
``repro_torch.api`` (``ConvSpec -> plan -> prepare_weights -> apply``).
"""

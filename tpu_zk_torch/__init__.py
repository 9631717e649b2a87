"""tpu_zk_torch: tpu_zk's basic sumcheck and linear-time GKR on PyTorch, with CUDA kernels for Hopper.

Imports torch and numpy, never JAX or ``tpu_zk``.  Tensors carry their
device; CUDA tensors go through the hand-written kernels of ``csrc/``, which
are built with nvcc into ``build/tpu_zk_torch/`` the first time a CUDA
tensor reaches one.
"""

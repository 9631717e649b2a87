"""tpu_zk_torch: tpu_zk's sumcheck, GKR, curves, MSM, multilinear KZG, succinct GKR, NTT, Merkle trees and FRI on PyTorch, with CUDA kernels for Hopper.

Imports torch and numpy, never JAX or ``tpu_zk``.  Tensors carry their
device; tensors made from host values go to the CUDA card unless the caller
asks for the CPU (:mod:`tpu_zk_torch.device`).  CUDA tensors go through the
hand-written kernels of ``csrc/``, which are built with nvcc into
``build/tpu_zk_torch/`` the first time a CUDA tensor reaches one.
"""

from .fields.arith import field_ctx

__all__ = ["field_ctx"]
__version__ = "0.1.0"

"""PyTorch/CUDA port of the MoE-Beyond reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs/``, ``models/``, ``kernels/``, ``core/``, ``serving/``) and
imports nothing from it. Plain tensor code is PyTorch; the TPU kernels on
the serving path are CUDA C++ kernels for Hopper (``kernels/csrc/``).

Float32 matmuls run in full float32: TF32 would flip router top-k choices
near ties, and the reduced configs run in f32 precisely for tight parity.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

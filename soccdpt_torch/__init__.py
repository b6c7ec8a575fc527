"""PyTorch/CUDA port of SOccDPT for one NVIDIA H100.

The JAX package ``soccdpt_tpu`` is the reference; this package keeps its
module layout and names (``core/``, ``ops/``, ``models/``,
``models/backbones/``, ``data/``, ``serving.py``) so each counterpart is
easy to find. It imports torch, numpy and the standard library only.

Hand-written Hopper kernels live in ``kernels/`` (Python wrappers) and
``csrc/`` (CUDA C++ for sm_90a, built with nvcc at first use). Each
wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors.
"""

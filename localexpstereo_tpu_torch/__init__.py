"""PyTorch + CUDA port of localexpstereo_tpu (local expansion moves stereo).

The package imports ``torch`` only. Its hot kernel, the fused expansion-move
min-cut, is hand-written CUDA C++ for Hopper (``csrc/expansion_accept.cu``)
and is built with ``nvcc`` at first use on a CUDA tensor; on CPU tensors
every kernel wrapper runs its plain PyTorch version instead.

Module names mirror the JAX package (``config``, ``ops/...``,
``models/...``) so each ported function has an obvious counterpart.
"""
from .config import COST_FOR_INVALID, PARAMS_GF, Parameters  # noqa: F401

__all__ = ["COST_FOR_INVALID", "PARAMS_GF", "Parameters"]

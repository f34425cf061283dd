"""multitreegp_tpu_torch: the PyTorch/CUDA port of ``multitreegp_tpu``.

Multi-tree genetic programming with the symbolic-regression main path on an
NVIDIA Hopper GPU: the population fitness (rollout + MSE) and the whole
reproduction step are hand-written CUDA kernels (``csrc/``), built with
``nvcc`` at first use. Every kernel has a plain PyTorch version beside it,
which is what runs on CPU tensors. This package never imports JAX.
"""
from .core.registry import FunctionSet, build_function_set
from .core.trees import TreeTensors
from .strategy import GeneticProgramming

__all__ = ["FunctionSet", "GeneticProgramming", "TreeTensors", "build_function_set"]

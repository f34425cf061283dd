"""multitreegp_tpu_torch: the PyTorch/CUDA port of ``multitreegp_tpu``.

Multi-tree genetic programming on an NVIDIA Hopper GPU: symbolic regression
of ODEs and SDEs (fixed-step and adaptive) and closed-loop control policies,
evolved with the fused reproduction kernel up to 256 rows a tree or with the
per-tree operators at any size, and constant optimisation. The population
fitness, the reproduction step and the tree interpreter are hand-written
CUDA kernels (``csrc/``), built with ``nvcc`` at first use. Every kernel has
a plain PyTorch version beside it, which is what runs on CPU tensors. This
package never imports JAX.
"""
from .core.registry import FunctionSet, build_function_set
from .core.trees import TreeTensors
from .strategy import GeneticProgramming

__all__ = ["FunctionSet", "GeneticProgramming", "TreeTensors", "build_function_set"]

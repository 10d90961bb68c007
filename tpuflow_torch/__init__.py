"""tpuflow_torch — the PyTorch/CUDA port of tpuflow.

Module paths and function names mirror :mod:`tpuflow` (the JAX package,
which stays the reference): ``tpuflow_torch.solvers.horn_schunck`` is the
counterpart of ``tpuflow.solvers.horn_schunck`` and so on. Functions take
and return ``torch.Tensor`` and run on the device of their inputs; the
entry points that take numpy frames (the streams of
``pipeline.streaming``, the flagship ``solvers.optical_flow_block_matching``)
take a ``device``, ``"cuda"`` unless the caller passes ``"cpu"``. On a
CUDA tensor the HS and BA sweep loops, the separable filters (Farneback's
and Lucas-Kanade's), Farneback's polynomial expansion and blur-solve, and
the flagship's mean-shift filter and region-gated sweep run hand-written
Hopper kernels
(``tpuflow_torch/csrc``, built with nvcc at first use); on a CPU tensor
they run the plain PyTorch version of the same function.

Importing the package has no side effects: it imports neither jax nor
tpuflow, and builds nothing.
"""

__version__ = "0.1.0"

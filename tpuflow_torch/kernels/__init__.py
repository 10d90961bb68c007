"""Hand-written Hopper kernels for the hot loops (HS and IRLS sweeps,
separable correlation, Farneback's expansion and blur-solve, the
flagship's mean-shift filter, region-gated IRLS sweep and region
matcher's moment sums), each beside its plain PyTorch version
(counterpart of :mod:`tpuflow.kernels`; the matcher's sums,
:mod:`~tpuflow_torch.kernels.bm_cost`, replace no TPU kernel).

A wrapper takes the plain version for CPU tensors and launches its CUDA
kernel for CUDA tensors, or raises; it never falls back. The kernels are
built at first launch (:mod:`tpuflow_torch.kernels._build`), never at
import.
"""

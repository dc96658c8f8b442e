"""Hand-written Hopper kernels for the model path, one per Pallas TPU kernel.

Each kernel ships as ``csrc/<name>.cu`` (CUDA C++ for sm_90a, plain C
interface, built by ``_build`` with nvcc at first launch), ``<name>.py``
(the ctypes wrapper with its launch counter, and the plain PyTorch version
of the same function), ``ops.py`` (dispatch on the tensors' device) and
``ref.py`` (the naive oracle). Ported so far: flash attention and the SSD
scan. Importing this package builds nothing and needs no CUDA.
"""

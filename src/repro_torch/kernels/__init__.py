"""Hand-written Hopper kernels for the model path, one per Pallas TPU kernel.

Each kernel ships as ``csrc/<name>.cu`` (CUDA C++ for sm_90a, plain C
interface, built by ``_build`` with nvcc at first launch), ``<name>.py``
(the ctypes wrapper with its launch counter, and the plain PyTorch version
of the same function), ``ops.py`` (dispatch on the tensors' device) and
``ref.py`` (the naive oracle). Ported: flash attention, the SSD scan and
the int8 absmax/quantize pair of the compression hop. Beside them, and
replacing no Pallas kernel, ``adamw.py`` holds the optimizer's multi-tensor
kernels (global-norm clip and AdamW over every leaf of a tree), which
``optim.adamw`` launches on CUDA leaves; its plain version is that
module's eager code; ``moe_dispatch.py`` holds the served MoE layer's
gather into an expert-major buffer and combine out of it, which
``models.moe`` reaches through ``ops`` where autograd records nothing.
Importing this package builds nothing and needs no CUDA.
"""

"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

Layout (mirrors ``repro.kernels``):

    kernels/<name>/kernel.py   ctypes wrapper of csrc/<name>.cu (CUDA tensors)
    kernels/<name>/ref.py      plain PyTorch version (CPU path and oracle)
    kernels/ops.py             dispatch wrappers used by the models
    kernels/_build.py          nvcc build + ctypes load, at first CUDA use
"""
from . import ops

__all__ = ["ops"]

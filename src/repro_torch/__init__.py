"""repro_torch — the PyTorch / CUDA port of the ``repro`` model stack.

The JAX package ``repro`` is the reference and is never imported here.  This
package mirrors its layout (``repro_torch/<subpkg>/<module>.py`` ↔
``repro/<subpkg>/<module>.py``); the TPU Pallas kernels are replaced by CUDA
C++ kernels for Hopper (``csrc/*.cu``, built at first use by
``kernels/_build.py``).

Entry points default to ``device="cuda"`` and raise without a card unless
the caller passes ``device="cpu"``.  Kernel wrappers dispatch on the
tensor's device alone: a CPU tensor takes the plain PyTorch version, a CUDA
tensor launches the kernel or raises.
"""

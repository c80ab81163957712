"""PyTorch/CUDA port of the GRIFFIN serving stack (``repro`` is the JAX
reference; every module here mirrors the same relative path there).

The package imports ``torch``, numpy and the standard library only.  Its
hand-written Hopper kernels live in ``csrc/`` and are built on first use
(``kernels/build.py``); on CPU tensors every wrapper runs the kernel's
plain PyTorch version instead (``kernels/ref.py``).
"""

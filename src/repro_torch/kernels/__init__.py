"""Hand-written Hopper kernels of the port.

Each kernel lives in ``<name>/`` as ``csrc/*.cu`` (CUDA C++ for sm_90a,
built by ``build.py`` into a shared library with a plain C interface and
bound with ``ctypes``), ``ref.py`` (the plain PyTorch version) and
``ops.py`` (the wrapper: plain version for CPU tensors only, the kernel
or an error for CUDA tensors, and a launch counter).
"""

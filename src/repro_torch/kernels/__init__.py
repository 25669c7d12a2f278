"""Hand-written CUDA kernels for the semiring products of the query path.

``bool_matmul`` (or-and) and ``tropical_matmul`` (min-plus): each has a
``csrc/*.cu`` kernel for sm_90a, a plain PyTorch version in ``ref.py`` and
a wrapper in ``ops.py`` that picks one by the device of its operands and
counts the kernel's launches.  ``_build`` compiles and loads the kernels.
"""

"""Hand-written CUDA kernels for the semiring products of the query path.

``bool_matmul`` (or-and) and ``tropical_matmul`` (min-plus): each has a
``csrc/*.cu`` kernel for sm_90a, a plain PyTorch version in ``ref.py`` and
a wrapper in ``ops.py`` that picks one by the device of its operands and
counts the kernel's launches.  Each also runs evalDG in one cooperative
launch, on device code shared through ``fixpoint.cuh``: ``bool_matmul``
the whole reach fixpoint (``or_and_fixpoint``), ``tropical_matmul`` the
dist answer by distance levels (``min_plus_settle``).
``_build`` compiles and loads the kernels.
"""

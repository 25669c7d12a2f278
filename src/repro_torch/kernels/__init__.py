"""Hand-written CUDA kernels for the semiring products of the query path.

``bool_matmul`` (or-and) and ``tropical_matmul`` (min-plus): each has a
``csrc/*.cu`` kernel for sm_90a, a plain PyTorch version in ``ref.py`` and
a wrapper in ``ops.py`` that picks one by the device of its operands and
counts the kernel's launches.  Each also runs evalDG's whole fixpoint over
its semiring in one cooperative launch (``or_and_fixpoint``,
``min_plus_fixpoint``), on device code shared through ``fixpoint.cuh``;
``tropical_matmul`` also finds evalDG's dist answer by distance levels in
one (``min_plus_settle``), the launch the engine runs.
``_build`` compiles and loads the kernels.
"""

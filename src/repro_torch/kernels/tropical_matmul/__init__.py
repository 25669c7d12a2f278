from .ops import min_plus_matmul
from .ref import INF, min_plus_matmul_ref

__all__ = ["INF", "min_plus_matmul", "min_plus_matmul_ref"]

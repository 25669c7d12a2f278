from .ops import or_and_matmul
from .ref import or_and_matmul_ref

__all__ = ["or_and_matmul", "or_and_matmul_ref"]

from .generate import erdos_renyi
from .graph import Graph, bfs_distances, bfs_reachable, csr_from_coo
from .partition import bfs_partition, random_partition

__all__ = ["Graph", "bfs_distances", "bfs_reachable", "csr_from_coo",
           "erdos_renyi", "bfs_partition", "random_partition"]

from .generate import erdos_renyi, labeled_chain_graph, preferential_attachment
from .graph import (Graph, bfs_distances, bfs_reachable, csr_from_coo,
                    out_degrees, reverse)
from .partition import (bfs_partition, block_partition, cut_stats,
                        hash_partition, random_partition)

__all__ = ["Graph", "bfs_distances", "bfs_reachable", "csr_from_coo",
           "out_degrees", "reverse", "erdos_renyi", "labeled_chain_graph",
           "preferential_attachment", "bfs_partition", "block_partition",
           "cut_stats", "hash_partition", "random_partition"]

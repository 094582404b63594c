from repro_torch.index.graph import GraphIndex
from repro_torch.index.builder import build_graph_index
from repro_torch.index.bruteforce import (filtered_knn_exact, knn_exact,
                                         recall_at_k, valid_mask)

__all__ = ["GraphIndex", "build_graph_index", "filtered_knn_exact",
           "knn_exact", "recall_at_k", "valid_mask"]

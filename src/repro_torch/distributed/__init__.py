"""Scale-out: the cross-shard merge of index-axis-sharded search, the
search meshes and the elastic mesh shapes (`repro/distributed`'s
counterpart). A mesh is single-controller — one process runs every
position's search on its device — and may list a device more than once
(a stated departure: a jax `Mesh` refuses duplicates), so one card or
the CPU runs every line of the mesh paths (`sharding.py`)."""
from repro_torch.distributed.fault_tolerance import (best_mesh_shape,
                                                     best_search_mesh_shape,
                                                     clamp_budgets)
from repro_torch.distributed.merge import (PAD_POS, butterfly_merge,
                                           merge_plan, merge_sorted_pools,
                                           merge_stacked, pool_positions)
from repro_torch.distributed.sharding import (BATCH_AXIS, INDEX_AXIS, Mesh,
                                              search_mesh_2d)

__all__ = ["best_mesh_shape", "best_search_mesh_shape", "clamp_budgets",
           "PAD_POS", "butterfly_merge", "merge_plan", "merge_sorted_pools",
           "merge_stacked", "pool_positions", "BATCH_AXIS", "INDEX_AXIS",
           "Mesh", "search_mesh_2d"]

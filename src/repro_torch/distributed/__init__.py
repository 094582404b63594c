"""Scale-out: the cross-shard merge of index-axis-sharded search and the
elastic mesh shapes (`repro/distributed`'s counterpart; the mesh path —
`sharding.py` and `butterfly_merge` — comes with several GPUs)."""
from repro_torch.distributed.fault_tolerance import (best_mesh_shape,
                                                     best_search_mesh_shape,
                                                     clamp_budgets)
from repro_torch.distributed.merge import PAD_POS, merge_plan, merge_stacked

__all__ = ["best_mesh_shape", "best_search_mesh_shape", "clamp_budgets",
           "PAD_POS", "merge_plan", "merge_stacked"]

"""The E2E pipeline on torch: state → step → backend → search → engine,
the probe → estimate → resume stages on top, and the planner (scan,
traverse, widen) beside them; `sharded` runs them over an index cut
into S slices (one graph each, merged top-k); `baselines` holds the
paper's §5 comparisons and `ref_search` the sequential Algorithm 1
oracle."""
from repro_torch.core.backends import available_backends, get_backend
from repro_torch.core.e2e import (E2EResult, e2e_search, predict_budgets,
                                  probe_and_features)
from repro_torch.core.engine import BIG_BUDGET, SearchEngine
from repro_torch.core.estimator import CostEstimator, spearman
from repro_torch.core.features import (FEATURE_NAMES, N_FEATURES,
                                       ablate_filter_features,
                                       extract_features, feature_names)
from repro_torch.core.gbdt import GBDTModel, train_gbdt
from repro_torch.core.planner import (PLANS, PlanResult, Planner,
                                      PlanTrainingData, choose_plans,
                                      fit_planner,
                                      generate_plan_training_data,
                                      planned_search, run_plan,
                                      stage0_scan_mask, static_features)
from repro_torch.core.plans import ScanStats, scan_search, scan_stats
from repro_torch.core.search import (dispatch_counters, run_search,
                                     run_search_persistent)
from repro_torch.core.sharded import (ShardedSearchEngine, ShardedSearchState,
                                      merge_shard_states)
from repro_torch.core.state import (SearchConfig, SearchState, concat_lanes,
                                    init_state, pad_lanes, prepare_resume,
                                    put_lanes, stack_shards, take_lanes,
                                    take_shard, topk_results)
from repro_torch.core.training import TrainingData, generate_training_data
from repro_torch.core import baselines

__all__ = [
    "available_backends", "get_backend", "E2EResult", "e2e_search",
    "predict_budgets", "probe_and_features", "BIG_BUDGET", "SearchEngine",
    "CostEstimator", "spearman", "FEATURE_NAMES", "N_FEATURES",
    "ablate_filter_features",
    "extract_features", "feature_names", "GBDTModel", "train_gbdt",
    "PLANS", "PlanResult", "Planner", "PlanTrainingData", "choose_plans",
    "fit_planner", "generate_plan_training_data", "planned_search",
    "run_plan", "stage0_scan_mask", "static_features", "ScanStats",
    "scan_search", "scan_stats",
    "dispatch_counters", "run_search", "run_search_persistent",
    "ShardedSearchEngine", "ShardedSearchState", "merge_shard_states",
    "SearchConfig", "SearchState", "concat_lanes", "init_state",
    "pad_lanes", "prepare_resume", "put_lanes", "stack_shards",
    "take_lanes", "take_shard", "topk_results", "TrainingData",
    "generate_training_data", "baselines",
]

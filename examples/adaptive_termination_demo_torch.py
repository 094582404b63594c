"""Anatomy of one adaptive termination decision (paper Fig. 4 / Alg. 1).

Shows, for a batch of mixed easy/hard filtered queries:
  - probe-phase filter features (rho_pilot, rho_queue) per query
  - predicted vs true W_q
  - NDC actually spent under E2E vs the naive fixed beam
  - batch-tail clamping (straggler mitigation)

Runs on the PyTorch/CUDA port, on `--device` (default: the CUDA device,
which must exist; `--device cpu` runs the kernels' plain versions); the
traversal backend is `REPRO_BACKEND` ("fused" by default, "persistent",
"dense").

    PYTHONPATH=src python examples/adaptive_termination_demo_torch.py [--device cpu]
"""
import argparse
import os

import numpy as np

from repro_torch.core import (CostEstimator, SearchConfig, SearchEngine,
                              baselines, e2e_search, generate_training_data)
from repro_torch.core.features import FEATURE_NAMES
from repro_torch.data import make_dataset, make_label_workload
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import clamp_budgets
from repro_torch.filters.predicates import PRED_CONTAIN
from repro_torch.index import build_graph_index, filtered_knn_exact
from repro_torch.index.bruteforce import recall_at_k


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    dev = resolve_device(ap.parse_args(argv).device)
    ds = make_dataset(n=8000, dim=48, n_clusters=16, alphabet_size=48, seed=0)
    graph = build_graph_index(ds.vectors, degree=24, seed=0, device=dev)
    engine = SearchEngine.build(ds, graph, device=dev,
                                backend=os.environ.get("REPRO_BACKEND", "fused"))
    cfg = SearchConfig(k=10, queue_size=512, pred_kind=PRED_CONTAIN)

    wl_tr = make_label_workload(ds, batch=512, kind="contain", seed=10)
    td = generate_training_data(engine, ds, wl_tr, cfg, probe_budget=96, chunk=128)
    est = CostEstimator.fit(td.features, td.w_q, n_trees=200, depth=5)

    wl = make_label_workload(ds, batch=16, kind="contain", hard_fraction=0.5,
                             seed=123)
    gt_idx, gt_dist = filtered_knn_exact(wl.queries, ds.vectors, wl.spec,
                                         ds.labels_packed, ds.values, 10,
                                         device=dev)
    # true W_q for reference
    td_ev = generate_training_data(engine, ds, wl, cfg, probe_budget=96, chunk=16)

    r = e2e_search(engine, est, cfg, wl.queries, wl.spec, probe_budget=96,
                   alpha=1.2)
    naive = baselines.naive_search(engine, cfg, wl.queries, wl.spec, 512)

    i_pilot = FEATURE_NAMES.index("rho_pilot")
    i_queue = FEATURE_NAMES.index("rho_queue")
    z = r.probe_features
    cnt, naive_cnt = r.state.cnt.cpu().numpy(), naive.cnt.cpu().numpy()
    rec = recall_at_k(r.state.res_idx.cpu().numpy(), gt_idx)
    budgets, flagged = clamp_budgets(r.predicted_budget, quantile=0.9)

    print(f"{'q':>3} {'hard':>4} {'rho_pilot':>9} {'rho_queue':>9} "
          f"{'W_true':>7} {'W_hat':>7} {'spent':>6} {'naive':>6} {'rec':>5} {'clamp':>5}")
    for i in range(wl.batch):
        print(f"{i:>3} {int(wl.hardness[i]):>4} {z[i, i_pilot]:>9.3f} "
              f"{z[i, i_queue]:>9.3f} {td_ev.w_q[i]:>7d} "
              f"{r.predicted_budget[i]:>7d} {int(cnt[i]):>6d} "
              f"{int(naive_cnt[i]):>6d} {rec[i]:>5.2f} {str(bool(flagged[i])):>5}")
    print(f"\nmean NDC: E2E={cnt.mean():.0f} "
          f"naive(ef=512)={naive_cnt.mean():.0f}  "
          f"recall: E2E={rec.mean():.3f} "
          f"naive={recall_at_k(naive.res_idx.cpu().numpy(), gt_idx).mean():.3f}")


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch/CUDA port: build an attributed index, train
the E2E cost estimator, compare adaptive termination against the naive
fixed-beam baseline, search with a composite filter from the filter
algebra, and (optionally) deploy the engine on a compressed vector store.

    PYTHONPATH=src python examples/quickstart_torch.py [--precision pq]
                                    [--plan auto|scan|widen|traverse]
                                    [--backend persistent] [--device cpu]

Everything runs on `--device` (default: the CUDA device, which must
exist; `--device cpu` runs the kernels' plain versions).

--precision int8|pq builds the engine with a quantized index: the
traversal evaluates distances in the compressed domain (int8 ADC dot / PQ
lookup tables) and every pipeline result is exact-reranked in float32 —
same API, ~4–13x smaller hot-loop index.

--backend picks the traversal hot path: "fused" (default, the fused
single-step kernel K1), "persistent" (kernel K5: up to
SearchConfig.steps_per_launch steps a launch with early-exit lane
compaction — bit-identical results, fewer launches), or "dense" (plain
PyTorch).

--plan picks the filter-execution strategy for the final composite-filter
step: "scan" (pre-filter: bitmap + masked exact top-k over the valid set),
"widen" (filtered-expansion traversal, 1-hop ∪ strided 2-hop frontier),
"traverse" (the standard E2E pipeline), or "auto" (default: the planner
routes each lane to the cheapest plan from its exact selectivity and
cost-head predictions).
"""
import argparse
import os
import time

import numpy as np

from repro_torch.core import (CostEstimator, SearchConfig, SearchEngine,
                              baselines, e2e_search, generate_training_data)
from repro_torch.data import make_dataset, make_label_workload
from repro_torch.device import resolve_device
from repro_torch.filters import And, Contain, Range
from repro_torch.filters.predicates import PRED_CONTAIN
from repro_torch.index import build_graph_index, filtered_knn_exact
from repro_torch.index.bruteforce import recall_at_k


def host(t):
    return t.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "int8", "pq"],
                    help="engine vector-store precision (compressed-domain "
                         "traversal + exact float32 rerank)")
    ap.add_argument("--plan", default="auto",
                    choices=["auto", "scan", "widen", "traverse"],
                    help="filter-execution strategy for the planned search "
                         "step (auto = per-lane planner routing)")
    ap.add_argument("--backend",
                    default=os.environ.get("REPRO_BACKEND", "fused"),
                    choices=["dense", "fused", "persistent"],
                    help="traversal backend (persistent groups "
                         "steps_per_launch steps per launch; results are "
                         "bit-identical to fused)")
    ap.add_argument("--explain", action="store_true",
                    help="print the per-query EXPLAIN lifecycle (features, "
                         "predicted Ŵ_q, per-stage NDC/launches, "
                         "termination reason) on every backend")
    ap.add_argument("--corpus", type=int, default=8000,
                    help="dataset size (shrink for smoke runs)")
    ap.add_argument("--train-queries", type=int, default=512,
                    help="estimator training workload size")
    ap.add_argument("--eval-batch", type=int, default=128,
                    help="evaluation query batch size")
    ap.add_argument("--plan-queries", type=int, default=256,
                    help="planner training workload size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== 1. synthetic attributed vectors (clustered, label-correlated)")
    ds = make_dataset(n=args.corpus, dim=48, n_clusters=16, alphabet_size=48,
                      seed=0)

    print("== 2. Vamana-style graph index (NN-descent + alpha-prune)")
    t0 = time.time()
    graph = build_graph_index(ds.vectors, degree=24, seed=0, device=dev)
    print(f"   built in {time.time()-t0:.1f}s, mean degree "
          f"{graph.out_degrees().float().mean():.1f}")
    engine = SearchEngine.build(ds, graph, backend=args.backend,
                                precision=args.precision, device=dev)
    print(f"   device={engine.device} backend={engine.backend}")
    if args.precision != "float32":
        from repro_torch.quant import store_ratio

        print(f"   quantized store ({engine.codec_key()}): "
              f"{store_ratio(engine.quant, engine.base_vectors):.1f}x "
              "smaller than float32; results below are exact-reranked")
    cfg = SearchConfig(k=10, queue_size=512, pred_kind=PRED_CONTAIN)

    print("== 3. offline W_q ground truth + GBDT estimator (paper 4.3)")
    wl_train = make_label_workload(ds, batch=args.train_queries,
                                   kind="contain", seed=10)
    td = generate_training_data(engine, ds, wl_train, cfg, probe_budget=96,
                                chunk=128)
    est = CostEstimator.fit(td.features, td.w_q, n_trees=200, depth=5)
    print("   estimator:", {k: round(v, 3)
                            for k, v in est.eval_metrics(td.features, td.w_q).items()})

    print("== 4. E2E adaptive termination vs naive fixed beam")
    wl = make_label_workload(ds, batch=args.eval_batch, kind="contain",
                             seed=99)
    gt_idx, _ = filtered_knn_exact(wl.queries, ds.vectors, wl.spec,
                                   ds.labels_packed, ds.values, 10,
                                   device=dev)
    for alpha in (1.0, 2.0):
        r = e2e_search(engine, est, cfg, wl.queries, wl.spec,
                       probe_budget=96, alpha=alpha)
        rec = recall_at_k(host(r.state.res_idx), gt_idx).mean()
        print(f"   E2E   alpha={alpha}: recall={rec:.3f} "
              f"mean NDC={host(r.state.cnt).mean():.0f}")
    for ef in (128, 512):
        st = baselines.naive_search(engine, cfg, wl.queries, wl.spec, ef)
        st = engine.rerank(cfg, wl.queries, st)  # no-op at float32
        rec = recall_at_k(host(st.res_idx), gt_idx).mean()
        print(f"   naive ef={ef}:  recall={rec:.3f} "
              f"mean NDC={host(st.cnt).mean():.0f}")

    print("== 5. composite filter (label contain AND value range)")
    # The filter algebra composes label and numeric predicates with
    # And/Or/Not; heterogeneous batches compile into one fixed-shape
    # predicate program, so the same estimator + engine serve them
    # unchanged. Here: "items tagged like my neighborhood AND value in the
    # middle band", one expression per query.
    exprs = [And(Contain(ds.label_sets[i][:1]), Range(0.4, 0.6))
             for i in np.random.default_rng(1).integers(0, ds.n, wl.batch)]
    gt_idx, _ = filtered_knn_exact(wl.queries, ds.vectors, exprs,
                                   ds.labels_packed, ds.value_matrix, 10,
                                   device=dev)
    r = e2e_search(engine, est, cfg, wl.queries, exprs, probe_budget=96,
                   alpha=1.5)
    rec = recall_at_k(host(r.state.res_idx), gt_idx).mean()
    print(f"   E2E composite: recall={rec:.3f} "
          f"mean NDC={host(r.state.cnt).mean():.0f}")

    print(f"== 6. adaptive plan routing (--plan {args.plan})")
    # The planner picks a filter-execution strategy per lane: selective
    # filters pre-filter scan (exact, σ·N distances), broad ones keep the
    # graph traversal, pathological middles widen the frontier. Training
    # labels both traversal variants from one shared probe per query.
    from repro_torch.core import (fit_planner, generate_plan_training_data,
                                  planned_search, run_plan)
    from repro_torch.data import make_composite_workload

    wl_plan = make_composite_workload(ds, batch=args.plan_queries,
                                      structure="mixed", seed=11)
    ptd = generate_plan_training_data(engine, ds, wl_plan, cfg,
                                      probe_budget=96, chunk=128)
    planner = fit_planner(ptd, probe_budget=96, n_trees=100, depth=5)
    if args.plan == "auto":
        res = planned_search(engine, planner, cfg, wl.queries, exprs,
                             probe_budget=96, alpha=1.5)
        st = res.state
        routed = {p: int((np.asarray(res.plan) == i).sum())
                  for i, p in enumerate(("scan", "traverse", "widen"))}
        print(f"   routed: {routed} "
              f"(stage-0 scans: {int(np.asarray(res.pre_probe).sum())})")
    else:
        st = run_plan(engine, planner, args.plan, cfg, wl.queries, exprs,
                      probe_budget=96, alpha=1.5)
    rec = recall_at_k(host(st.res_idx), gt_idx).mean()
    print(f"   plan={args.plan}: recall={rec:.3f} "
          f"mean NDC={host(st.cnt).mean():.0f} "
          f"(standard traversal above: "
          f"{host(r.state.cnt).mean():.0f})")

    if args.explain:
        print("== 7. EXPLAIN: per-query lifecycle, every backend")
        # explain=True returns one QueryReport per lane: the probe features
        # the prediction was made from, Ŵ_q vs the NDC actually spent,
        # per-stage launch counts (the persistent backend's come from
        # driver-observed dispatch counters), and the termination reason
        # (budget = the paper's adaptive stop; queue-drained = the valid
        # sub-graph ran out first; greedy = HNSW-style convergence).
        from repro_torch.obs import Tracer, format_reports

        wl_x = make_label_workload(ds, batch=4, kind="contain", seed=123)
        for backend in ("dense", "fused", "persistent"):
            eng_x = (engine if backend == args.backend
                     else SearchEngine.build(ds, graph, backend=backend,
                                             precision=args.precision,
                                             device=dev))
            tr = Tracer()
            rx = e2e_search(eng_x, est, cfg, wl_x.queries, wl_x.spec,
                            probe_budget=96, alpha=1.5, tracer=tr,
                            explain=True)
            print(f"-- backend={backend} ({tr.n_emitted} lifecycle spans)")
            print(format_reports(rx.reports[:2], features=True))
        # the planner's EXPLAIN includes routing: plan-stage0 / plan-select
        # stages and per-plan execution (scan lanes terminate
        # "scan-exhaustive" — they paid σ·N exactly, no estimator involved)
        res = planned_search(engine, planner, cfg, wl.queries[:4], exprs[:4],
                             probe_budget=96, alpha=1.5, explain=True)
        print("-- planned_search (auto routing)")
        print(format_reports(res.reports))
        # on an index-axis-sharded engine the same report grows a per-shard
        # section: each shard's NDC/hops/termination at its ⌈W/S⌉ budget
        # slice (the per-shard numbers sum exactly to the merged counters
        # above them), plus the merge topology and a work-balance index
        from repro_torch.core.sharded import ShardedSearchEngine
        from repro_torch.index.builder import build_sharded_graph_index

        sgraph = build_sharded_graph_index(np.asarray(ds.vectors), 2,
                                           degree=24, seed=0, device=dev)
        eng_s = ShardedSearchEngine.build(ds, sgraph, backend=args.backend,
                                          mesh=None,
                                          precision=args.precision,
                                          device=dev)
        rs = e2e_search(eng_s, est, cfg, wl_x.queries, wl_x.spec,
                        probe_budget=96, alpha=1.5, explain=True)
        print("-- e2e_search on a 2-shard engine (per-shard attribution)")
        print(format_reports(rs.reports[:2]))


if __name__ == "__main__":
    main()

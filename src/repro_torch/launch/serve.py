"""Serving launcher — thin client of the `repro_torch.serve` subsystem.

Counterpart of `repro/launch/serve.py`'s engine half. Mixed (contain +
range) filtered-AKNN requests flow through the cost-aware scheduler on the
card: admission with backpressure → shared probe → GBDT cost estimate →
budget-bucketed micro-batches → resume/requeue on the carried SearchState.
Easy queries complete in short-budget batches instead of waiting on the
hardest lane of a fixed batch; hard queries are routed (or time-sliced)
into long-budget batches.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 64 --batch 16
    PYTHONPATH=src python -m repro_torch.launch.serve --explain 4 --status \\
        --prometheus --trace-out spans.jsonl

It runs on the CUDA device and raises when there is none, unless
`--device cpu` is given. The traversal backend is `REPRO_BACKEND`
(default "persistent": kernel K5 between compactions; "fused" steps
kernel K1, "dense" is plain PyTorch). `--shards S` > 1 deploys an
index-axis-sharded engine (`core.sharded`, the loop over shards on one
device); its per-shard telemetry shows in `--status` and `--prometheus`.
`--gen-len N` adds the filtered-RAG tail on the same device: each served
request's retrieved ids, as context tokens ahead of an 8-token prompt,
condition the `tiny()` config of `--arch` (default olmo-1b; a dense or
MoE decoder LM, deepseek-v3-671b's MLA with its latent cache,
mamba2-2.7b's SSM layers with their recurrent state, zamba2-2.7b's
hybrid of both with its shared attention block; weights drawn from seed
0), which prefills and greedy-decodes N tokens with its cache. The VLM
and the enc-dec need a memory (image patches, audio frames) that the
tail has no source for, and raise ValueError.

    PYTHONPATH=src python -m repro_torch.launch.serve --gen-len 8 --arch olmo-1b
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def build_world(corpus: int, train_queries: int, queue_size: int, k: int,
                probe: int, backend: str | None, seed: int = 0,
                precision: str = "float32", device=None, n_shards: int = 1):
    """Index + graph + engine on `device` + a single estimator trained on a
    *mixed* contain/range workload (features are predicate-agnostic, so one
    GBDT serves both request kinds). `precision` deploys the engine with a
    compressed vector store (int8 / pq) — the estimator is then trained on
    the same engine, so its cost model sees compressed-domain probes, and
    the scheduler reranks every finished lane with exact float32.
    `n_shards > 1` deploys an index-axis-sharded engine (`core.sharded`)
    with one graph per corpus slice (the corpus is rounded up to a
    multiple of S); the estimator is trained on that sharded engine, so it
    models the ⌈W/S⌉-split cost."""
    from repro_torch.core import (CostEstimator, SearchConfig, SearchEngine,
                                  generate_training_data)
    from repro_torch.data import (make_dataset, make_label_workload,
                                  make_range_workload)
    from repro_torch.device import resolve_device
    from repro_torch.filters.predicates import PRED_CONTAIN, PRED_RANGE
    from repro_torch.index import build_graph_index

    dev = resolve_device(device)
    # equal contiguous slices need S | N
    corpus = -(-corpus // max(n_shards, 1)) * max(n_shards, 1)
    ds = make_dataset(n=corpus, dim=48, n_clusters=16, alphabet_size=48,
                      seed=seed)
    if n_shards > 1:
        from repro_torch.core.sharded import ShardedSearchEngine
        from repro_torch.index import build_sharded_graph_index

        graph = build_sharded_graph_index(ds.vectors, n_shards, degree=24,
                                          seed=seed, device=dev)
        engine = ShardedSearchEngine.build(ds, graph, backend=backend,
                                           mesh=None, precision=precision,
                                           device=dev)
    else:
        graph = build_graph_index(ds.vectors, degree=24, seed=seed,
                                  device=dev)
        engine = SearchEngine.build(ds, graph, backend=backend, device=dev,
                                    precision=precision)
    cfg = SearchConfig(k=k, queue_size=queue_size, pred_kind=PRED_CONTAIN)

    half = train_queries // 2
    feats, w_q = [], []
    for kind, pred in (("contain", PRED_CONTAIN), ("range", PRED_RANGE)):
        wl = (make_label_workload(ds, batch=half, kind=kind, seed=7)
              if kind == "contain" else
              make_range_workload(ds, batch=half, seed=8))
        td = generate_training_data(
            engine, ds, wl, dataclasses.replace(cfg, pred_kind=pred),
            probe_budget=probe, chunk=128)
        feats.append(td.features)
        w_q.append(td.w_q)
    est = CostEstimator.fit(np.concatenate(feats), np.concatenate(w_q),
                            n_trees=120, depth=5)
    return ds, graph, engine, cfg, est


def mixed_requests(ds, n: int, seed: int = 100, hard_fraction: float = 0.5):
    """Interleaved contain/range requests (heterogeneous difficulty)."""
    from repro_torch.data import make_label_workload, make_range_workload
    from repro_torch.serve import requests_from_workload

    wl_c = make_label_workload(ds, batch=(n + 1) // 2, kind="contain",
                               hard_fraction=hard_fraction, seed=seed)
    wl_r = make_range_workload(ds, batch=n // 2,
                               hard_fraction=hard_fraction, seed=seed + 1)
    reqs = (requests_from_workload(wl_c, start_rid=0)
            + requests_from_workload(wl_r, start_rid=wl_c.batch))
    rng = np.random.default_rng(seed)
    rng.shuffle(reqs)
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16,
                    help="micro-batch lane width")
    ap.add_argument("--alpha", type=float, default=1.5)
    ap.add_argument("--buckets", default="256,1024,4096",
                    help="ascending NDC bucket caps (a final unbounded "
                         "bucket is always appended)")
    ap.add_argument("--policy", default="direct",
                    choices=["direct", "escalate"])
    ap.add_argument("--probe", type=int, default=64)
    ap.add_argument("--queue-capacity", type=int, default=None,
                    help="admission bound; default admits the whole "
                         "--requests stream (pass a smaller value to "
                         "demonstrate load shedding)")
    ap.add_argument("--corpus", type=int, default=6000)
    ap.add_argument("--train-queries", type=int, default=256)
    ap.add_argument("--queue-size", type=int, default=128,
                    help="search beam width M")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--gen-len", type=int, default=0,
                    help="greedy-decode N tokens of a decoder LM conditioned "
                         "on each request's retrieved ids (the RAG tail)")
    ap.add_argument("--arch", default="olmo-1b",
                    help="the LM of the RAG tail (its tiny() config; dense, "
                         "MoE, SSM or hybrid family, gqa or MLA)")
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "int8", "pq"],
                    help="engine vector-store precision: compressed-domain "
                         "traversal + exact float32 rerank on completion")
    ap.add_argument("--shards", type=int, default=1,
                    help="index-axis shards (>1 deploys core.sharded: "
                         "per-shard traversal at ceil(W/S) budgets + "
                         "cross-shard merge; per-shard skew telemetry "
                         "shows up in --status and --prometheus)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, which "
                         "must exist; 'cpu' runs the plain versions)")
    ap.add_argument("--status", action="store_true",
                    help="print the structured JSON health report (queue, "
                         "shard skew, calibration, drift alarms) after "
                         "the run")
    ap.add_argument("--explain", type=int, default=0, metavar="N",
                    help="trace request lifecycles and print the first N "
                         "served timelines (admit → probe → resume slices "
                         "→ complete)")
    ap.add_argument("--trace-out", default=None,
                    help="stream lifecycle spans to this JSONL file")
    ap.add_argument("--prometheus", action="store_true",
                    help="print a Prometheus text-format scrape (serving + "
                         "calibration metrics) after the run")
    args = ap.parse_args(argv)

    from repro_torch.obs import Tracer
    from repro_torch.serve import CostAwareScheduler, ServeConfig

    print("== index + estimator bring-up")
    ds, graph, engine, cfg, est = build_world(
        args.corpus, args.train_queries, args.queue_size, args.k, args.probe,
        backend=os.environ.get("REPRO_BACKEND", "persistent"),
        precision=args.precision, device=args.device, n_shards=args.shards)
    print(f"   device={engine.device} backend={engine.backend}")
    if args.shards > 1:
        print(f"   index-axis sharded: {engine.n_shards} shards x "
              f"{engine.shard_size} rows")
    if args.precision != "float32" and args.shards <= 1:
        from repro_torch.quant import store_ratio

        print(f"   quantized store ({engine.codec_key()}): "
              f"{store_ratio(engine.quant, engine.base_vectors):.1f}x "
              "smaller than float32")

    buckets = tuple(int(x) for x in args.buckets.split(",") if x) + (None,)
    # the launcher submits the whole stream before pumping, so the default
    # admission bound must cover it — otherwise an idle system sheds load
    capacity = (args.queue_capacity if args.queue_capacity is not None
                else max(512, args.requests))
    scfg = ServeConfig(lane_width=args.batch, buckets=buckets,
                       policy=args.policy, probe_budget=args.probe,
                       alpha=args.alpha, queue_capacity=capacity)
    t0 = time.perf_counter()
    # the tracer shares the launcher's relative clock, so span timestamps
    # line up with request arrival/completion times in the timelines below
    tracer = (Tracer(clock=lambda: time.perf_counter() - t0,
                     sink=args.trace_out)
              if (args.explain or args.trace_out) else None)
    sched = CostAwareScheduler(engine, est, cfg, scfg, tracer=tracer)

    print(f"== serving {args.requests} mixed contain/range requests "
          f"(lanes={args.batch}, buckets={buckets}, policy={args.policy})")
    reqs = mixed_requests(ds, args.requests)
    try:
        for r in reqs:
            sched.submit(r, time.perf_counter() - t0)
        sched.run_until_idle(time.perf_counter() - t0)

        s = sched.summary()
        lat, ndc = s["latency"], s["ndc"]
        print(f"retrieval: p50/p95/p99 = {1e3*lat['p50']:.1f}/"
              f"{1e3*lat['p95']:.1f}/{1e3*lat['p99']:.1f} ms  "
              f"NDC p50/p95/p99 = {ndc['p50']:.0f}/{ndc['p95']:.0f}/"
              f"{ndc['p99']:.0f}")
        print(f"batches={s['n_batches']} requeues={s['n_requeues']} "
              f"shed={s['n_shed']} cache_hit_rate="
              f"{s['cache']['hit_rate']:.2f} queue_depth_max="
              f"{s['queue_depth_max']} launches={s['launches_total']}")

        rep = sched.calibration_report()
        if rep and rep["n_records"]:
            plans = " ".join(f"{k}:{v['n']}(win={v['win_rate']:.2f})"
                             for k, v in rep["per_plan"].items())
            print(f"calibration: n={rep['n_records']} "
                  f"log_rmse={rep['log_rmse']:.3f} over/under="
                  f"{rep['overprediction_rate']:.2f}/"
                  f"{rep['underprediction_rate']:.2f}  {plans}")

        if args.explain:
            print(f"== lifecycle timelines (first {args.explain} requests)")
            for r in reqs[: args.explain]:
                print(f"request {r.rid} [{r.trace_id}] "
                      f"plan={r.plan or 'traverse'} budget={r.budget} "
                      f"ndc={r.ndc} probe_ndc={r.probe_ndc} "
                      f"slices={r.n_slices} cache_hit={r.cache_hit}")
                for sp in tracer.spans(trace_id=r.trace_id):
                    extras = "".join(f"  {k}={v}"
                                     for k, v in sp.attrs.items()
                                     if k != "rid")
                    t = (f" (+{1e3 * sp.duration:.1f}ms)"
                         if sp.duration > 0 else "")
                    print(f"  {1e3 * (sp.t0 - (r.arrival or 0.0)):8.1f}ms "
                          f"{sp.name}{t}{extras}")
    finally:
        if tracer is not None:
            tracer.close()

    if args.status:
        print("== serving health")
        print(json.dumps(sched.status(), indent=2, sort_keys=True))

    if args.prometheus:
        print("== prometheus scrape")
        print(sched.prometheus(), end="")

    if args.gen_len > 0:
        _generate(args, reqs)
    return sched


def _generate(args, reqs, model=None):
    """Filtered-RAG tail: retrieved ids condition a decoder LM.

    Each served request's ids (|id| mod vocab) followed by an 8-token
    prompt (seeded numpy draws, as the reference's) are prefilled as one
    batch; the first maximum of the logits is fed back for
    `args.gen_len` − 1 KV-cache decode steps (`train.generate`). `model`
    defaults to `build_model(get_arch(args.arch).tiny())` on
    `args.device` with seed 0. Prints the `generation:` line; returns the
    generated ids [b, gen_len] (None when no request was served). A model
    that cross-attends (vlm, encdec) raises ValueError: the tail feeds
    tokens alone, as the reference's does, which fails there too."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.zoo import refuse_memory
    from repro_torch.train import generate

    refuse_memory(get_arch(args.arch) if model is None else model.cfg,
                  "the RAG tail")
    done = [r for r in reqs if r.res_idx is not None]
    if not done:
        print("generation: skipped (no served requests)")
        return None
    if model is None:
        model = build_model(get_arch(args.arch).tiny(), device=args.device)
    dev, vocab = model.device, model.cfg.vocab_size
    b = len(done)
    doc_ids = np.stack([np.abs(r.res_idx) % vocab for r in done])
    prompts = np.random.default_rng(0).integers(0, vocab, (b, 8))
    tokens = torch.from_numpy(np.concatenate([doc_ids, prompts], axis=1)
                              .astype(np.int32)).to(dev)
    run = generate(model, tokens, args.gen_len - 1)
    gen = run["ids"].cpu().numpy()
    ms = run["prefill_ms"] + run["decode_ms"]
    print(f"generation: {ms/b:.1f} ms/req ({args.gen_len} tokens, "
          f"{model.cfg.name} tiny, {b} requests)")
    return gen


if __name__ == "__main__":
    main()

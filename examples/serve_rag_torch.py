"""End-to-end RAG on the PyTorch/CUDA port — a thin client of
`repro_torch.serve` and `repro_torch.models`.

Per request: (1) the query vector stands in for an embedded prompt, (2) the
cost-aware scheduler serves the filtered AKNN search (admission → shared
probe → budget estimate → budget-bucketed micro-batch → resume/requeue),
(3) retrieved doc ids are prepended as context tokens, (4) batched greedy
decode with a KV cache.

Per-query budgets come from the cost estimator, and hard queries are
*routed* to long-budget buckets so they never stall their easy batchmates.
Everything runs on `--device` (default: the CUDA device, which must
exist; `--device cpu` runs the kernels' plain versions). The traversal
backend is `REPRO_BACKEND` (default "persistent"; "fused", "dense").

    PYTHONPATH=src python examples/serve_rag_torch.py [--device cpu]
"""
import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import (CostEstimator, SearchConfig, SearchEngine,
                              generate_training_data)
from repro_torch.data import make_dataset, make_label_workload
from repro_torch.device import resolve_device
from repro_torch.filters.predicates import PRED_CONTAIN
from repro_torch.index import build_graph_index
from repro_torch.models import build_model
from repro_torch.serve import (CostAwareScheduler, ServeConfig,
                               requests_from_workload)
from repro_torch.train import generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch, gen_len = 8, 12

    print("== retrieval substrate (E2E)")
    ds = make_dataset(n=6000, dim=48, n_clusters=12, alphabet_size=32, seed=0)
    graph = build_graph_index(ds.vectors, degree=24, seed=0, device=dev)
    engine = SearchEngine.build(
        ds, graph, backend=os.environ.get("REPRO_BACKEND", "persistent"),
        device=dev)
    cfg = SearchConfig(k=4, queue_size=256, pred_kind=PRED_CONTAIN)
    wl_tr = make_label_workload(ds, batch=256, kind="contain", seed=7)
    td = generate_training_data(engine, ds, wl_tr, cfg, probe_budget=64,
                                chunk=128)
    est = CostEstimator.fit(td.features, td.w_q, n_trees=150, depth=5)
    print(f"   device={engine.device} backend={engine.backend}")

    print("== LM (olmo-family tiny config)")
    mcfg = get_arch("olmo-1b").tiny()
    model = build_model(mcfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))

    print("== batched requests: prompt + label filter, via the scheduler")
    wl = make_label_workload(ds, batch=batch, kind="contain", seed=42)
    sched = CostAwareScheduler(
        engine, est, cfg,
        ServeConfig(lane_width=batch, buckets=(256, 1024, None),
                    probe_budget=64, alpha=1.5))
    reqs = requests_from_workload(wl)

    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r, time.perf_counter() - t0)
    sched.run_until_idle(time.perf_counter() - t0)
    s = sched.summary()
    doc_ids = np.stack([r.res_idx for r in reqs])
    print(f"   retrieval: p99 {1e3*s['latency']['p99']:.1f} ms, "
          f"mean NDC={np.mean([r.ndc for r in reqs]):.0f}, "
          f"{s['n_requeues']} hard-query requeues, "
          f"{s['n_batches']} micro-batches")

    # context = [doc tokens] + prompt tokens (stub tokenization of doc ids)
    prompt_len = 8
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, mcfg.vocab_size, (batch, prompt_len))
    ctx = np.concatenate([np.abs(doc_ids) % mcfg.vocab_size, prompts], axis=1)
    tokens = torch.from_numpy(ctx.astype(np.int32)).to(dev)

    print("== prefill + batched greedy decode")
    run = generate(model, tokens, gen_len - 1)
    gen = run["ids"].cpu().numpy()
    print(f"   decoded {gen_len} tokens x {batch} requests "
          f"({run['decode_ms']/(gen_len*batch):.2f} ms/token/request)")
    print("   sample generations (token ids):")
    for b in range(min(3, batch)):
        print(f"   req{b}: docs={doc_ids[b].tolist()} -> {gen[b].tolist()}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the persistent e2e batch of two checkouts on one card, in turns.

    python3 scripts/pair_e2e.py BEFORE AFTER [--n 100000]
                                            # runs BEFORE, AFTER, AFTER, BEFORE

Each turn is a process that imports that checkout's `src/` and, on the
card, builds a Tripclick-shaped index (d=768, `tripclick-s` labels, N as
given), trains an estimator on 128 contain queries, and times
`e2e_search` (backend "persistent", contain α=1, 64 lanes, probe 96,
queue 512) on the host clock around a synchronised call: the median of
`REPEATS` calls, with their spread, and the launch loop's launches. A
checkout whose `e2e_search` takes a `tracer` is timed traced too. So two
trees' host overhead around the kernels is compared within one call.
Prints one JSON line per turn, then the card's `nvidia-smi` name and
power limit. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

REPEATS = 15


def turn(root: str, n: int) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    from repro_torch.core import (CostEstimator, SearchConfig, SearchEngine,
                                  dispatch_counters, e2e_search,
                                  generate_training_data)
    from repro_torch.data.synthetic import (DATASET_PRESETS, make_dataset,
                                            make_label_workload)
    from repro_torch.index.builder import build_graph_index
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    preset = dict(DATASET_PRESETS["tripclick-s"])
    preset.update(n=n, dim=768)
    ds = make_dataset(name="tripclick", n_value_attrs=2, **preset)
    graph = build_graph_index(ds.vectors, degree=32, seed=0, device=dev)
    eng = SearchEngine.build(ds, graph, device=dev)
    cfg = SearchConfig(k=10, queue_size=512, backend="persistent")
    td = generate_training_data(
        eng, ds, make_label_workload(ds, batch=128, kind="contain", seed=10),
        cfg, probe_budget=96, chunk=128)
    est = CostEstimator.fit(td.features, td.w_q, n_trees=200, depth=5)
    wl = make_label_workload(ds, batch=64, kind="contain", seed=20)

    def timed(**kw):
        ms = []
        for _ in range(REPEATS + 2):  # the first two warm up
            torch.cuda.synchronize()
            d0 = dispatch_counters()["launches"]
            t = time.perf_counter()
            e2e_search(eng, est, cfg, wl.queries, wl.spec, probe_budget=96,
                       alpha=1.0, n_probes=2, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            launches = dispatch_counters()["launches"] - d0
        ms = np.asarray(ms[2:])
        return {"median_ms": float(np.median(ms)),
                "p25_ms": float(np.percentile(ms, 25)),
                "p75_ms": float(np.percentile(ms, 75)),
                "launches": launches}

    out = {"root": root, "n": n, "untraced": timed()}
    if "tracer" in inspect.signature(e2e_search).parameters:
        from repro_torch.obs import Tracer

        out["traced"] = timed(tracer=Tracer())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--turn", action="store_true",
                    help="internal: time one checkout in this process")
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(os.path.abspath(args.roots[0]), args.n)),
              flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("give BEFORE and AFTER")
    before, after = (os.path.abspath(r) for r in args.roots)
    for i, root in enumerate((before, after, after, before)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", root,
             "--n", str(args.n)], capture_output=True, text=True,
            timeout=1200)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": i, **line}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

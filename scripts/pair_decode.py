#!/usr/bin/env python3
"""Time the full-width olmo-1b decode of two checkouts on one card, in turns.

    python3 scripts/pair_decode.py BEFORE AFTER   # BEFORE, AFTER, AFTER, BEFORE

Each turn is a process that imports that checkout's `src/` and, on the
card, builds `build_model(get_arch("olmo-1b"))` at full width (float32,
TF32 off) from a seeded `torch.Generator`, prefills a [16, 18] token
batch and greedy-decodes 32 tokens with the KV cache, through the
checkout's own generation loop: `repro_torch.train.generate` where the
checkout has it, else prefill, `_pad_cache_seq` and `decode_step` at
positions given as a tensor. The decode loop is timed on the host clock,
the card synchronised at both ends: the median of `REPEATS` runs a turn,
with their spread, in ms a token. So two trees' decode paths are compared
within one call. Prints one JSON line per turn, then the card's
`nvidia-smi` name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPEATS = 7
BATCH, PROMPT, STEPS = 16, 18, 32


def turn(root: str) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    from repro_torch import train
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.transformer import _pad_cache_seq

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_arch("olmo-1b")
    lm = build_model(cfg, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)).to(dev)

    def loop_ms() -> float:
        if hasattr(train, "generate"):
            return train.generate(lm, tokens, STEPS)["decode_ms"]
        logits, part = lm.prefill(tokens)
        cache = _pad_cache_seq(lm.init_cache(BATCH, PROMPT + STEPS), part)
        cur = train.greedy(logits)[:, None]
        pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for s in range(STEPS):
            logits, cache = lm.decode_step(cache, cur, pos + s)
            cur = train.greedy(logits)[:, None]
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    loop_ms()                                                  # warm-up
    ms = np.asarray([loop_ms() / STEPS for _ in range(REPEATS)])
    return {"root": root, "loop": ("generate" if hasattr(train, "generate")
                                   else "decode_step"),
            "batch": BATCH, "steps": STEPS,
            "decode_ms_per_token_median": float(np.median(ms)),
            "p25": float(np.percentile(ms, 25)),
            "p75": float(np.percentile(ms, 75)),
            "all": ms.tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--turn", action="store_true",
                    help="internal: time one checkout in this process")
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(os.path.abspath(args.roots[0]))), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("give BEFORE and AFTER")
    before, after = (os.path.abspath(r) for r in args.roots)
    for i, root in enumerate((before, after, after, before)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", root],
            capture_output=True, text=True, timeout=600)
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

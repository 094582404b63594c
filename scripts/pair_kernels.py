#!/usr/bin/env python3
"""Time the traversal kernels of two checkouts on one card, in turns.

    python3 scripts/pair_kernels.py BEFORE AFTER     # runs BEFORE, AFTER,
                                                     # AFTER, BEFORE

Each turn is a process that takes BEFORE's or AFTER's `chip_smoke.py` and
`src/` and runs that checkout's own kernel checks at the main path's
shapes (B=64, d=768, M=512, K=10; K5 over its N=1M synthetic index):
K1 at R=32 and R'=160, K3, K4 and K5's three branches. Each check holds
the kernel against its plain version and times it, so both checkouts are
measured by their own code on the same card within one call. Prints one
JSON line per turn, {"root", "turn", "ms": {kernel: device ms},
"call_ms": {...}}, then the card's `nvidia-smi` name and power limit.
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

CHECKS = (  # (kernel, chip_smoke function, its arguments after the device)
    ("K1", "check_step_kernel", ()),
    ("K1 R'=160", "check_step_kernel", ("float32", 160)),
    ("K3", "check_step_kernel", ("int8",)),
    ("K4", "check_step_kernel", ("pq",)),
    ("K5", "check_k5", ()),
    ("K5 int8", "check_k5_codec", ("int8",)),
    ("K5 pq", "check_k5_codec", ("pq",)),
)


def one_turn(root: str) -> dict:
    """Run `root`'s checks in this process and return their times."""
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import contextlib
    import io

    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    device = torch.device("cuda")
    ms, call_ms = {}, {}
    for name, fn, extra in CHECKS:
        with contextlib.redirect_stdout(io.StringIO()):  # its phase lines
            out = getattr(chip_smoke, fn)(device, *extra)
        ms[name], call_ms[name] = out["ms"], out["call_ms"]
    return {"root": root, "ms": ms, "call_ms": call_ms}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one_turn(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    before, after = argv
    for turn, root in enumerate((before, after, after, before)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": turn, **line}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

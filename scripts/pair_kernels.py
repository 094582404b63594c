#!/usr/bin/env python3
"""Time the traversal kernels of two checkouts on one card, in turns.

    python3 scripts/pair_kernels.py BEFORE AFTER     # runs BEFORE, AFTER,
                                                     # AFTER, BEFORE

Each turn is a process that imports BEFORE's or AFTER's `src/` (the
kernels, built from that checkout's `csrc/`) and runs THIS checkout's
kernel checks on them, so both are timed by the same code within one
call: K1 at R=32 and R'=160, K3, K4 and K5's three branches at the main
path's shapes (B=64, d=768, M=512, K=10; K5 over its N=1M synthetic
index), K6 at B=64, R=32, and K6's row-id variant at the "mixed" forced
scan's shape (B=64, N=1M, V=2^19, ≈11.1 M pairs) and the oracle's (V =
2^18). Each check holds the kernel against its plain version. Prints one
JSON line per turn, {"root", "turn", "ms": {kernel: device ms},
"call_ms": {...}}, then the card's `nvidia-smi` name and power limit.
Needs a CUDA device and nvcc; the wrappers' signatures must be the same
in both checkouts.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = (  # (kernel, chip_smoke function, its arguments after the device)
    ("K1", "check_step_kernel", ()),
    ("K1 R'=160", "check_step_kernel", ("float32", 160)),
    ("K3", "check_step_kernel", ("int8",)),
    ("K4", "check_step_kernel", ("pq",)),
    ("K5", "check_k5", ()),
    ("K5 int8", "check_k5_codec", ("int8",)),
    ("K5 pq", "check_k5_codec", ("pq",)),
    ("K6", "check_k6", ()),
    ("K6 rows", "time_k6_rows", ("scan",)),
    ("K6 rows oracle", "time_k6_rows", ("oracle",)),
)


def one_turn(root: str) -> dict:
    """Run this checkout's checks on `root`'s kernels in this process and
    return their times."""
    root = os.path.abspath(root)
    sys.path.insert(0, os.path.join(root, "src"))
    import contextlib
    import io

    import torch

    import repro_torch  # noqa: F401  (root's package, before chip_smoke's)
    from repro_torch.kernels import _build

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    device = torch.device("cuda")
    ms, call_ms = {}, {}
    for name, fn, extra in CHECKS:
        with contextlib.redirect_stdout(io.StringIO()):  # its phase lines
            out = getattr(chip_smoke, fn)(device, *extra)
        ms[name], call_ms[name] = out["ms"], out["call_ms"]
    return {"root": root, "src": os.path.dirname(repro_torch.__file__),
            "ms": ms, "call_ms": call_ms}


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

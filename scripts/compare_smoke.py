#!/usr/bin/env python3
"""Compare the result fields of two `chip_smoke.py` runs.

    python3 scripts/compare_smoke.py BEFORE.log AFTER.log

Reads the JSON phase lines of each run's standard output, pairs the n-th
line of each phase in one with the n-th of the same phase in the other,
and compares every field that is a result: ids, counts, recalls, NDC,
plan shares, equalities, shapes. Fields that are measurements (times,
rates, clocks, card memory, idle shares and shares of a bound, the
profiler's kernel counts and copies, which vary from run to run of one
tree) are left out by name
(`MEASURED`). Prints one JSON line per phase line that differs, with the
differing fields, then a summary line {"phase_lines": n, "equal": m, "differ": [...],
"only_before": [...], "only_after": [...]}.
"""
from __future__ import annotations

import json
import re
import sys

# measurement fields, by name: times, rates, clocks, memory, profiler counts
MEASURED = re.compile(
    r"(^|_)(ms|seconds|s|mib)$|_ms_|(^|_)(idle_share|share_of_bound|"
    r"share_of_weight_bound)$|^(ms|wall_ms|e2e_ms|fused_e2e_ms|"
    r"device_idle_share|kernel_ms|top_kernels|stage_seconds|"
    r"kernel_launches|kernel_launches_per_step|htod_copies|nvidia_smi|"
    r"torch|cuda|hbm_bytes_per_s|sm_mhz|profiler_ms|timed_launch|busy|"
    r"launch_share_of_wall|samples)$")


def phase_lines(path: str) -> dict:
    """{(phase, n): fields} for every JSON phase line of a log."""
    out, seen = {}, {}
    for line in open(path, errors="replace"):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        name = obj.get("phase") or next(iter(obj), "?")
        n = seen.get(name, 0)
        seen[name] = n + 1
        out[(name, n)] = obj
    return out


def strip(obj):
    """`obj` without its measurement fields, at every depth."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if not MEASURED.search(k)}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


def diff(a, b, path=""):
    """Paths at which a and b differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                side = "after" if k in b else "before"
                out.append(f"{path}.{k} (only in {side})")
            else:
                out += diff(a[k], b[k], f"{path}.{k}")
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in diff(x, y, f"{path}[{i}]")]
    return [] if a == b else [path or "."]


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    before, after = (phase_lines(p) for p in argv)
    differ, equal = [], 0
    for key in (k for k in before if k in after):
        d = diff(strip(before[key]), strip(after[key]))
        if d:
            differ.append(f"{key[0]}#{key[1]}")
            print(json.dumps({"phase": key[0], "n": key[1], "fields": d}))
        else:
            equal += 1
    print(json.dumps({
        "phase_lines": len(set(before) & set(after)), "equal": equal,
        "differ": differ,
        "only_before": [f"{p}#{n}" for p, n in before if (p, n) not in after],
        "only_after": [f"{p}#{n}" for p, n in after if (p, n) not in before]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

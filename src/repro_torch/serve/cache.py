"""Per-(query, filter) result cache.

Counterpart of `repro/serve/cache.py`. Results are kept as host numpy
arrays (copied off the device once, when the request completes). Keys are SHA-1 digests over the *full byte content* of the query vector and
the filter's canonical DNF serialization (`filters.expr.canonical_key`),
plus every search parameter that changes the answer (k, queue size, α,
probe budget, …). Canonicalization makes the key semantic up to
commutativity: `And(a, b)` and `And(b, a)` collide on purpose (same filter,
same compiled program, same traversal), while `And(a, b)` vs `Or(a, b)`
and any structural/leaf difference — a contain vs an equal over the same
labels, a range whose float bytes happen to shadow a label encoding — stay
distinct because kind tags, negation flags, and exact float hex forms are
all part of the canonical serialization.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np

from repro_torch.filters.expr import canonical_key


def request_key(req, k: int, queue_size: int, alpha: float,
                probe_budget: int, min_budget: int = 32,
                max_budget: int = 1 << 30, n_probes: int = 2,
                ablate_filter: bool = False,
                codec: str = "float32", plan: str = "traverse") -> str:
    """`codec` is the engine's codec identity (`SearchEngine.codec_key()`):
    precision tag + codec-parameter digest. Quantization changes traversal
    order and the surviving candidate pool, hence the answer — two engines
    differing only in precision (or in a retrained codebook) must never
    share cache entries.

    `plan` is the configured execution plan ("auto" or a forced plan). It
    is part of the key exactly because different plans return different
    answers (scan is exact, the traversals are approximate) — but it enters
    the digest only when it *can* change the result: "traverse" hashes
    identically to the pre-planner key (legacy entries stay valid), and an
    auto completion that executed some plan X through the same bitwise path
    a forced-X run would take is additionally stored under the forced-X key
    by the scheduler (dual put), so auto and forced deployments share
    entries whenever sharing is sound. See tests/test_serve.py's
    plan-collision matrix (mirrored in tests/test_torch_serve.py) for the
    exact hit/miss contract."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(req.query, np.float32).tobytes())
    h.update(b"|filter:")
    h.update(canonical_key(req.get_expr()))
    h.update(b"|k:%d|m:%d|a:%r|f:%d|lo:%d|hi:%d|np:%d|abl:%d"
             % (k, queue_size, alpha, probe_budget, min_budget, max_budget,
                n_probes, ablate_filter))
    h.update(b"|codec:" + codec.encode())
    if plan != "traverse":
        h.update(b"|plan:" + plan.encode())
    return h.hexdigest()


class ResultCache:
    """LRU cache of completed results (res_idx, res_dist, ndc)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._d: OrderedDict[str, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: str):
        hit = self._d.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key: str, res_idx: np.ndarray, res_dist: np.ndarray,
            ndc: int) -> None:
        self._d[key] = (np.asarray(res_idx).copy(),
                        np.asarray(res_dist).copy(), int(ndc))
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

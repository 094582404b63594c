"""Fault tolerance and straggler handling (host only).

Counterpart of `repro/distributed/fault_tolerance.py`:

1. **Elastic mesh selection** — after a node failure the job restarts on
   whatever device count survives; `best_mesh_shape` picks the largest
   usable (pod, data, model) factorization and `best_search_mesh_shape`
   the largest (data, index) search mesh whose index axis owns whole
   shards.
2. **Step watchdog** — `StepMonitor` tracks per-step wall times; a step
   over `factor` × the trailing median is a straggler event.
3. **Search-tail clamping** — `clamp_budgets` caps per-lane predicted
   budgets at a batch quantile and reports the clamped lanes, which the
   serving layer can re-queue into a "hard query" batch.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


def best_mesh_shape(n_devices: int, model_parallel: int = 16,
                    pod_size: int = 256) -> tuple[tuple, tuple]:
    """Largest (pod, data, model) mesh using ≤ n_devices: model is the
    tensor-parallel degree, pods whole multiples of pod_size, the rest
    the data axis."""
    if n_devices >= 2 * pod_size:
        pods = n_devices // pod_size
        data = pod_size // model_parallel
        return (pods, data, model_parallel), ("pod", "data", "model")
    model = min(model_parallel, n_devices)
    data = max(1, n_devices // model)
    return (data, model), ("data", "model")


def best_search_mesh_shape(n_devices: int, n_shards: int,
                           ) -> tuple[tuple, tuple]:
    """Largest valid 2-D (data, index) search mesh using ≤ n_devices.

    The index axis must own whole shards (its size divides `n_shards`),
    so it is the largest divisor of the device count that also divides
    the shard count; the rest goes to batch parallelism. With 7 devices
    and 4 shards the index axis collapses to 1 instead of wedging the
    restart.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    index = max(i for i in range(1, min(n_devices, n_shards) + 1)
                if n_devices % i == 0 and n_shards % i == 0)
    return (n_devices // index, index), ("data", "index")


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


class StepMonitor:
    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.durations: list[float] = []
        self.events: list[StragglerEvent] = []
        self._t0 = None
        self._step = 0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> StragglerEvent | None:
        dt = time.monotonic() - self._t0
        self._step += 1
        return self.observe(self._step, dt)

    def observe(self, step: int, duration: float) -> StragglerEvent | None:
        hist = self.durations[-self.window:]
        self.durations.append(duration)
        if len(hist) >= 8:
            med = float(np.median(hist))
            if duration > self.factor * med:
                ev = StragglerEvent(step=step, duration=duration, median=med)
                self.events.append(ev)
                return ev
        return None


def clamp_budgets(budgets: np.ndarray, quantile: float = 0.95,
                  floor: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Cap per-lane search budgets at the batch quantile → (clamped
    budgets, mask of the clamped lanes)."""
    budgets = np.asarray(budgets)
    cap = max(float(np.quantile(budgets, quantile)), floor)
    clamped = np.minimum(budgets, cap).astype(budgets.dtype)
    return clamped, budgets > cap

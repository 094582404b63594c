"""Query-lifecycle tracing: spans at real dispatch boundaries.

Counterpart of `repro/obs/trace.py`, with the same API and span stream.
Every request (serving) or batch pipeline invocation (one-shot) carries a
trace ID; `Span`s with monotonic timestamps and structured attributes cover
the lifecycle stages the paper's cost model reasons about:

  admit → probe → feature-extract/estimate → plan-select → resume launches
  (steps, width, compaction — from the persistent launch loop) → rerank → complete

Design constraints (pinned by tests/test_torch_obs.py):

  * spans are emitted only at host-level dispatch points that already
    exist (an `engine.search` call, a persistent launch with its
    `hops`/`active` readback, a scheduler pump), so results are bit for
    bit the same with tracing on and off, and no device synchronization
    is added inside any launch loop;
  * span attributes are plain Python scalars/strings at emit time. A span
    must never retain a tensor: a CUDA tensor would pin device memory,
    and reading one (`int()` of a 0-d CUDA tensor included) synchronizes
    the device — so `_host_scalar` rejects every `torch.Tensor`;
  * memory is bounded: spans land in a ring (`deque(maxlen=capacity)`);
    an optional JSONL sink streams them out for offline analysis. The sink
    is bounded too — at `sink_max_bytes` the file rotates to `<path>.1`
    (replacing any previous rotation), so total disk use stays ≤ ~2× the
    cap no matter how long the process serves.

The tracer is clock-injected like the serving scheduler: pass `clock=` to
drive it from a virtual clock or leave the default `time.perf_counter`
(monotonic) for wall-clock tracing. The wall clock measures host work: a
span around device work covers it only where the wrapped code waits for
the device, as the persistent launch loop's readback does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import time
from collections import deque

import numpy as np
import torch

#: ring default — ~100 B/span of attrs keeps this well under 10 MB
DEFAULT_CAPACITY = 1 << 16

#: sink default — rotate the JSONL file once it reaches 64 MB, keeping one
#: predecessor (`<path>.1`), so a long-running serve process holds at most
#: ~2× this on disk
DEFAULT_SINK_MAX_BYTES = 64 << 20

_SCALARS = (str, int, float, bool, type(None))


def _host_scalar(v):
    """Coerce an attribute value to a plain host scalar (never a device
    array). numpy scalars become Python numbers; anything array-like is a
    bug at the call site — spans carry summaries, not tensors. Every
    `torch.Tensor` is refused, 0-d ones included: converting a CUDA one
    here would synchronize the device inside the traced region."""
    if isinstance(v, torch.Tensor):
        raise TypeError(
            f"span attribute is a torch.Tensor ({tuple(v.shape)}, "
            f"{v.device}) — spans must carry plain host scalars")
    if isinstance(v, _SCALARS):
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    raise TypeError(
        f"span attribute of type {type(v).__name__} — spans must carry "
        "plain host scalars (summarize arrays before emitting)")


@dataclasses.dataclass
class Span:
    """One lifecycle interval: [t0, t1] in the tracer's clock units."""

    trace_id: str
    name: str
    t0: float
    t1: float = 0.0
    attrs: dict = dataclasses.field(default_factory=dict)

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_json(self) -> str:
        return json.dumps(dict(trace=self.trace_id, name=self.name,
                               t0=self.t0, t1=self.t1, **self.attrs),
                          sort_keys=True)


class Tracer:
    """Bounded in-memory span ring + optional JSONL sink.

    Trace IDs are deterministic counters (``q-000001``) — no RNG, so a
    traced run is replayable and two identically-driven runs produce
    identical span streams (up to timestamps)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock=time.perf_counter, sink: str | None = None,
                 sink_max_bytes: int = DEFAULT_SINK_MAX_BYTES):
        self.capacity = capacity
        self.clock = clock
        self._ring: deque[Span] = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self.n_emitted = 0          # lifetime count (ring may have evicted)
        self._sink_path = sink
        self.sink_max_bytes = int(sink_max_bytes)
        self.n_rotations = 0
        self._sink = open(sink, "a") if sink else None
        # appending to a pre-existing file: count what's already there
        self._sink_bytes = self._sink.tell() if self._sink else 0

    # ------------------------------------------------------------- ids ----
    def new_trace(self, prefix: str = "q") -> str:
        return f"{prefix}-{next(self._ids):06d}"

    # ----------------------------------------------------------- record ----
    def emit(self, name: str, trace_id: str = "", t0: float | None = None,
             t1: float | None = None, **attrs) -> Span:
        """Record a completed span (t1 defaults to t0: an instant event)."""
        now = self.clock()
        t0 = now if t0 is None else t0
        t1 = t0 if t1 is None else t1
        sp = Span(trace_id=trace_id, name=name, t0=float(t0), t1=float(t1),
                  attrs={k: _host_scalar(v) for k, v in attrs.items()})
        self._append(sp)
        return sp

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str = "", **attrs):
        """Context manager measuring the enclosed host work. The yielded
        span is mutable — `sp.set(steps=..., ndc=...)` attaches attributes
        discovered during the work (host scalars only)."""
        sp = Span(trace_id=trace_id, name=name, t0=self.clock(),
                  attrs={k: _host_scalar(v) for k, v in attrs.items()})
        try:
            yield sp
        finally:
            sp.t1 = self.clock()
            sp.attrs = {k: _host_scalar(v) for k, v in sp.attrs.items()}
            self._append(sp)

    def _append(self, sp: Span) -> None:
        self._ring.append(sp)
        self.n_emitted += 1
        if self._sink is not None:
            line = sp.to_json() + "\n"
            if (self._sink_bytes > 0
                    and self._sink_bytes + len(line) > self.sink_max_bytes):
                self._rotate_sink()
            self._sink.write(line)
            self._sink_bytes += len(line)

    def _rotate_sink(self) -> None:
        """Roll the sink file to `<path>.1` and start a fresh one. A span
        larger than the cap still lands (a file always takes ≥1 line)."""
        self._sink.close()
        os.replace(self._sink_path, self._sink_path + ".1")
        self._sink = open(self._sink_path, "w")
        self._sink_bytes = 0
        self.n_rotations += 1

    # ------------------------------------------------------------ query ----
    def __len__(self) -> int:
        return len(self._ring)

    def spans(self, trace_id: str | None = None,
              name: str | None = None) -> list[Span]:
        """Spans still in the ring, oldest first, optionally filtered."""
        return [s for s in self._ring
                if (trace_id is None or s.trace_id == trace_id)
                and (name is None or s.name == name)]

    def clear(self) -> None:
        self._ring.clear()

    # ------------------------------------------------------------- sink ----
    def flush(self) -> None:
        if self._sink is not None:
            self._sink.flush()

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None


class _NullSpan:
    """Inert span: accepts attribute writes, records nothing."""

    __slots__ = ("attrs",)

    def __init__(self):
        self.attrs = {}

    def set(self, **attrs):
        return self


class NullTracer:
    """No-op tracer — the default everywhere, so untraced call sites pay
    one attribute lookup and nothing else."""

    capacity = 0
    n_emitted = 0

    def new_trace(self, prefix: str = "q") -> str:
        return ""

    def emit(self, name, trace_id="", t0=None, t1=None, **attrs):
        return _NullSpan()

    @contextlib.contextmanager
    def span(self, name, trace_id="", **attrs):
        yield _NullSpan()

    def __len__(self):
        return 0

    def spans(self, trace_id=None, name=None):
        return []

    def clear(self):
        pass

    def flush(self):
        pass

    def close(self):
        pass


#: shared inert instance — `tr = tracer or NO_TRACE` normalizes call sites
NO_TRACE = NullTracer()


def as_tracer(tracer) -> "Tracer | NullTracer":
    return NO_TRACE if tracer is None else tracer

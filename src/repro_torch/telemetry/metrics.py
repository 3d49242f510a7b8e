"""Metric registry — counters, gauges, fixed-bucket histograms, typed events.

This absorbs the ad-hoc ``stats()`` dicts that used to be scattered across
the serving scheduler (latency percentiles, queue depth), the board runtime
(cycle/energy accounts), and the resilience tier (detector/recovery ledger):
one registry per owner, every mutation under one internal lock, so a
``snapshot()`` is **consistent** — totals read together were true together,
and successive snapshots are monotone for counters (no torn reads while
worker lanes keep mutating).

  * ``Counter`` — monotone int/float accumulator (``inc``);
  * ``Gauge``   — last-write scalar, plus ``set_max`` for peak tracking;
  * ``Histogram`` — FIXED bucket boundaries (chosen at registration, never
    adapted — cross-run comparability is the point) plus a bounded exact-
    value window so the legacy exact percentiles (p50/p95/p99) survive;
  * typed events — lane state-machine transitions, detector firings and
    circuit-breaker trips become ``Event`` records with structured fields,
    not loose dict keys; a bounded ring keeps the most recent ones.

``snapshot()`` is the scheduler-facing consistent read. (A pure-Python copy
of ``repro.telemetry.metrics``; its exporters are in ``telemetry.export``.)
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque

#: default request-latency boundaries (us) — fixed across runs and PRs so
#: histograms stay comparable; the +inf bucket is implicit
LATENCY_BUCKETS_US = (50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 25000.0, 50000.0, 100000.0, 250000.0,
                      500000.0, 1000000.0)
#: recovery-latency boundaries (ms)
RECOVERY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                       1000.0, 2500.0)
#: queue-depth / batch-fill boundaries (requests)
DEPTH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
                 1024.0)


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0


class Histogram:
    """Fixed-boundary histogram + bounded exact window for percentiles."""

    __slots__ = ("name", "buckets", "counts", "sum", "count", "window")

    def __init__(self, name: str, buckets: tuple,
                 window: int = 65536):
        if tuple(buckets) != tuple(sorted(buckets)):
            raise ValueError(f"histogram {name!r}: bucket boundaries must be "
                             f"sorted, got {buckets}")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # +1 = the +inf bucket
        self.sum = 0.0
        self.count = 0
        self.window: deque = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.sum += v
        self.count += 1
        self.window.append(v)

    def percentile(self, q: float) -> float:
        """Exact percentile over the bounded window (the legacy p50/p95/p99
        semantics); falls back to 0.0 when empty."""
        if not self.window:
            return 0.0
        vals = sorted(self.window)
        if len(vals) == 1:
            return vals[0]
        # linear interpolation, matching numpy.percentile's default
        pos = (len(vals) - 1) * (q / 100.0)
        lo = math.floor(pos)
        hi = math.ceil(pos)
        if lo == hi:
            return vals[lo]
        return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


@dataclasses.dataclass(frozen=True)
class Event:
    """One typed occurrence (lane transition, detector firing, breaker trip).
    ``seq`` is the registry-global order; ``fields`` is structured data."""

    seq: int
    name: str
    fields: dict


class MetricsRegistry:
    """Get-or-create registry; every mutation and every read shares one
    lock, so snapshots are consistent and counter totals are monotone
    across successive reads even under concurrent writers."""

    EVENT_WINDOW = 8192

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self.events: deque[Event] = deque(maxlen=self.EVENT_WINDOW)
        self._event_seq = 0
        self._events_dropped = 0

    # ------------------------------------------------------------- creation
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, buckets: tuple = LATENCY_BUCKETS_US,
                  window: int = 65536) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, buckets, window)
            elif tuple(h.buckets) != tuple(float(b) for b in buckets):
                raise ValueError(f"histogram {name!r} already registered "
                                 f"with boundaries {h.buckets}")
            return h

    # ------------------------------------------------------------- mutation
    def inc(self, name: str, n: float = 1) -> None:
        c = self.counter(name)
        with self._lock:
            c.value += n

    def set_gauge(self, name: str, v: float) -> None:
        g = self.gauge(name)
        with self._lock:
            g.value = v

    def set_max(self, name: str, v: float) -> None:
        g = self.gauge(name)
        with self._lock:
            if v > g.value:
                g.value = v

    def observe(self, name: str, v: float,
                buckets: tuple = LATENCY_BUCKETS_US) -> None:
        h = self.histogram(name, buckets)
        with self._lock:
            h.observe(v)

    def event(self, name: str, **fields) -> Event:
        """Record a typed event and bump its ``events_<name>`` counter —
        the counter survives the bounded ring, so totals stay exact."""
        c = self.counter(f"events_{name}")
        with self._lock:
            if len(self.events) == self.events.maxlen:
                self._events_dropped += 1
            ev = Event(self._event_seq, name, fields)
            self._event_seq += 1
            self.events.append(ev)
            c.value += 1
            return ev

    # ---------------------------------------------------------------- reads
    def get(self, name: str, default: float = 0):
        with self._lock:
            c = self._counters.get(name)
            if c is not None:
                return c.value
            g = self._gauges.get(name)
            if g is not None:
                return g.value
            return default

    def events_for(self, name: str) -> list[Event]:
        with self._lock:
            return [e for e in self.events if e.name == name]

    def snapshot(self) -> dict:
        """One consistent read of everything: counters, gauges, histogram
        summaries (count/sum/mean/p50/p95/p99), event totals. All values
        were true at the same instant — the torn-read fix for ``stats()``."""
        with self._lock:
            snap: dict = {}
            for name, c in self._counters.items():
                snap[name] = c.value
            for name, g in self._gauges.items():
                snap[name] = g.value
            for name, h in self._hists.items():
                snap[f"{name}_count"] = h.count
                snap[f"{name}_sum"] = h.sum
                snap[f"{name}_mean"] = h.mean()
                snap[f"{name}_p50"] = h.percentile(50)
                snap[f"{name}_p95"] = h.percentile(95)
                snap[f"{name}_p99"] = h.percentile(99)
            snap["events_total"] = self._event_seq
            snap["events_dropped"] = self._events_dropped
            return snap

    # the exporter needs typed access (not the flattened snapshot)
    def collect(self) -> tuple[list[Counter], list[Gauge], list[Histogram]]:
        with self._lock:
            return (list(self._counters.values()),
                    list(self._gauges.values()),
                    list(self._hists.values()))

    def reset(self) -> None:
        """Zero everything in place (post-warmup semantics). Registered
        metric OBJECTS survive — holders of a Counter/Histogram reference
        keep a live handle, only the accumulated values are cleared."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                g.value = 0.0
            for h in self._hists.values():
                h.counts = [0] * (len(h.buckets) + 1)
                h.sum = 0.0
                h.count = 0
                h.window.clear()
            self.events.clear()
            self._event_seq = 0
            self._events_dropped = 0

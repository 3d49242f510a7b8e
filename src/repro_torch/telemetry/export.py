"""Telemetry exporters: JSONL trace dumps and Prometheus text exposition.

The port of ``repro.telemetry.export``, over the port's ``Tracer``,
``MetricsRegistry`` and program cache; the text it writes is the JAX
package's for the same contents.

JSONL — one span per line in ``Span.full()`` form (canonical fields + wall
clocks + host meta), sorted by (trace, sid) so a dump of a deterministic run
is itself deterministic modulo the wall/meta fields. ``read_jsonl`` loads a
dump back into plain dicts; ``canonical_lines`` strips the nondeterministic
fields for cross-run diffing.

Prometheus — ``prometheus_text(registry)`` renders every counter, gauge and
histogram in the standard exposition format (``# TYPE`` headers, cumulative
``_bucket{le=...}`` counts, ``_sum``/``_count``), ready for a scrape
endpoint or a textfile collector:

    curl localhost:9000/metrics     # if served
    repro_lane_faults 3
    repro_request_latency_us_bucket{le="500.0"} 117

``program_cache_text()`` projects the active ``ProgramCache`` — residency,
byte gauge, eviction and hit/miss counters — through the same renderer, so
the LRU budget is scrapeable next to the serving metrics:

    repro_program_cache_bytes 33629
    repro_program_cache_evictions 2
"""

from __future__ import annotations

import json
import os

from repro_torch.core.lowering import get_cache
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.trace import Tracer


# --------------------------------------------------------------------- JSONL
def write_jsonl(tracer: Tracer, path: str) -> int:
    """Dump every recorded span, one JSON object per line; returns the span
    count. Creates parent directories as needed."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    spans = tracer.sorted_spans()
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s.full(), sort_keys=True,
                               separators=(",", ":")) + "\n")
    return len(spans)


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def canonical_lines(path: str) -> list[dict]:
    """The dump with wall clocks and host meta stripped — two seeded runs'
    dumps must agree on this exactly."""
    out = []
    for d in read_jsonl(path):
        out.append({k: d[k] for k in
                    ("trace", "sid", "parent", "name", "scope", "attrs")})
    return out


# ---------------------------------------------------------------- Prometheus
def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _name(prefix: str, name: str) -> str:
    safe = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)
    return f"{prefix}_{safe}" if prefix else safe


def prometheus_text(registry: MetricsRegistry, prefix: str = "repro") -> str:
    """Render the registry in Prometheus exposition format. Histogram bucket
    counts are cumulative and always end with the ``+Inf`` bucket, per the
    format spec."""
    counters, gauges, hists = registry.collect()
    lines: list[str] = []
    for c in sorted(counters, key=lambda x: x.name):
        n = _name(prefix, c.name)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {_fmt(c.value)}")
    for g in sorted(gauges, key=lambda x: x.name):
        n = _name(prefix, g.name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_fmt(g.value)}")
    for h in sorted(hists, key=lambda x: x.name):
        n = _name(prefix, h.name)
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for b, cnt in zip(h.buckets, h.counts):
            cum += cnt
            lines.append(f'{n}_bucket{{le="{b}"}} {cum}')
        cum += h.counts[-1]
        lines.append(f'{n}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{n}_sum {_fmt(h.sum)}")
        lines.append(f"{n}_count {h.count}")
    return "\n".join(lines) + "\n"


def program_cache_text(cache=None, prefix: str = "repro") -> str:
    """Prometheus exposition for a ``ProgramCache`` (default: the active
    one). Monotonic totals render as counters, residency as gauges."""
    st = (cache if cache is not None else get_cache()).stats()
    reg = MetricsRegistry()
    for name in ("evictions", "program_hits", "program_misses",
                 "bundle_hits", "bundle_misses"):
        reg.inc(f"program_cache_{name}", st[name])
    reg.set_gauge("program_cache_bytes", st["bytes"])
    reg.set_gauge("program_cache_programs", st["programs"])
    reg.set_gauge("program_cache_bundles", st["bundles"])
    if st["max_bytes"] is not None:
        reg.set_gauge("program_cache_max_bytes", st["max_bytes"])
    return prometheus_text(reg, prefix)

"""Deterministic structured tracing — the span side of the telemetry tier.

A span records one step of a request's life (``submit -> admission ->
batch-form -> lane -> runtime -> kernel -> decode -> complete``) with

  * an explicit **scope tag** on every span — ``"accel"`` (device/datapath
    work only: the paper's accelerator-scope) or ``"system"`` (everything a
    request actually pays: queueing, encode, packing, dispatch, readback) —
    the §2.3 measurement discipline made structural, so accelerator-only and
    system-level numbers can never be conflated inside one trace;
  * **logical clocks** in ``attrs`` — tick / event / cycle counts taken from
    the board cost model (deterministic, seed-reproducible integers), the
    currency every cross-run comparison uses;
  * **wall clocks** in dedicated fields (``wall_ns_start`` / ``wall_ns_end``)
    and host-only context in ``meta`` (lane id, thread, runtime impl) —
    excluded from the canonical form, so two runs of the same seed produce
    **bit-identical canonical span trees** even though wall time and thread
    placement differ.

Span ids are sequential *per trace* (a trace is one request, one batch, or
one standalone forward), and parent/child causality is explicit — the tree
for a given trace is deterministic as long as the traced work is, regardless
of how traces from different threads interleave in the global buffer.

The module-level recorder is a shared no-op by default: an un-instrumented
process pays one attribute load and one method call per site, with **zero
per-event allocation** (``span()`` returns the same singleton context
manager every time; ``emit()``/``begin()`` return ``None``). Install a
``Tracer`` to start recording:

    from repro_torch.telemetry import trace
    t = trace.Tracer()
    prev = trace.install(t)
    try:
        ...  # anything instrumented records into t
    finally:
        trace.install(prev)

Hot paths that must build attr dicts should guard on ``trace.enabled()``.

**Device spans.** The LM's prefill path opens ``device_span(name)`` at each
stage it walks: the ``prefill`` root (``training/lm_step.py``), the
``embed``, ``attn``, ``ffn`` and ``head`` stages that tile a forward, the
``norm`` and ``rope`` sites inside them, and ``moe_ffn`` and ``moe.route``
(``models/moe.py``). While a torch profiler runs, a site opens a
``_RecordFunctionFast`` range of its name: the profiler's own trace shows it
on the profiler's clock as the parent of the ops under it, so each kernel is
read under the spans that launched it, and the device's idle gaps under the
span the host was in. Never ``record_function``: that opens a
user-annotation range, which the profiler mirrors onto the device as if it
were an operation. A span adds no work to the device, so a traced run reads
the device as an untraced one does. With no profiler running a site costs
one ``_profiler_enabled()`` call and returns the shared null context.

``device_count(name, value)`` adds to a count while a profiler runs (the
MoE layer's expert-buffer rows and the assignments it kept): a device
tensor is summed when ``device_counts()`` reads the counts, so the forward
launches no kernel and waits for none. ``reset_device_counts()`` empties
them.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import threading
import time

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

#: the only legal scope tags — every span carries exactly one (the paper's
#: accelerator-only vs system-level measurement split)
SCOPES = ("accel", "system")


class Span:
    """One recorded step. ``attrs`` holds deterministic logical-clock data
    (ints/floats/strs from seeded computation); ``meta`` and the wall fields
    hold host-nondeterministic context and are excluded from ``canonical``."""

    __slots__ = ("trace", "sid", "parent", "name", "scope", "attrs", "meta",
                 "wall_ns_start", "wall_ns_end")

    def __init__(self, trace: str, sid: int, parent: int | None, name: str,
                 scope: str, attrs: dict | None, meta: dict | None,
                 wall_ns_start: int):
        self.trace = trace
        self.sid = sid
        self.parent = parent
        self.name = name
        self.scope = scope
        self.attrs = attrs if attrs is not None else {}
        self.meta = meta if meta is not None else {}
        self.wall_ns_start = wall_ns_start
        self.wall_ns_end = wall_ns_start

    @property
    def wall_us(self) -> float:
        return (self.wall_ns_end - self.wall_ns_start) / 1e3

    def canonical(self) -> dict:
        """The deterministic projection: everything except wall clocks and
        ``meta``. Two seeded runs must agree on this bit for bit."""
        return {"trace": self.trace, "sid": self.sid, "parent": self.parent,
                "name": self.name, "scope": self.scope, "attrs": self.attrs}

    def full(self) -> dict:
        """The export form: canonical + wall clocks + host meta."""
        d = self.canonical()
        d["wall_ns_start"] = self.wall_ns_start
        d["wall_ns_end"] = self.wall_ns_end
        d["meta"] = self.meta
        return d


class _SpanCtx:
    """Context manager wrapping begin/end with thread-local nesting."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span | None):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span | None:
        if self._span is not None:
            self._tracer._push(self._span)
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._span is not None:
            self._tracer._pop(self._span)
            self._span.wall_ns_end = time.perf_counter_ns()
        return False


class _NullSpanCtx:
    """The disabled-path singleton: no allocation, no state, no effect."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_CTX = _NullSpanCtx()


class NullRecorder:
    """Module default: every API is a no-op returning shared singletons."""

    enabled = False

    def span(self, name, scope, trace=None, parent=None, attrs=None,
             meta=None) -> _NullSpanCtx:
        return _NULL_CTX

    def begin(self, name, scope, trace=None, parent=None, attrs=None,
              meta=None) -> None:
        return None

    def end(self, span, attrs=None) -> None:
        return None

    def emit(self, name, scope, trace=None, parent=None, attrs=None,
             meta=None) -> None:
        return None


class Tracer:
    """A recording span buffer, bounded at ``max_spans`` (drops past the
    bound are counted in ``dropped``, never raised on the hot path)."""

    enabled = True

    def __init__(self, max_spans: int = 1 << 18):
        self.max_spans = int(max_spans)
        self.spans: list[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._auto = itertools.count()        # standalone-trace id counter
        self._sids: dict[str, itertools.count] = {}
        self._tls = threading.local()

    # ------------------------------------------------------------ internals
    def _stack(self) -> list[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()

    def current(self) -> Span | None:
        """The innermost context-managed span on this thread, if any."""
        st = self._stack()
        return st[-1] if st else None

    def _record(self, name: str, scope: str, trace: str | None,
                parent: int | None, attrs: dict | None,
                meta: dict | None) -> Span | None:
        if scope not in SCOPES:
            raise ValueError(f"span scope must be one of {SCOPES}, got "
                             f"{scope!r} (every span carries an explicit "
                             "accel|system tag)")
        cur = self.current()
        if trace is None:
            if cur is not None:
                trace = cur.trace
                if parent is None:
                    parent = cur.sid
            else:
                with self._lock:
                    trace = f"t{next(self._auto)}"
        elif parent is None and cur is not None and cur.trace == trace:
            parent = cur.sid
        now = time.perf_counter_ns()
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
                return None
            sid = next(self._sids.setdefault(trace, itertools.count()))
            span = Span(trace, sid, parent, name, scope, attrs, meta, now)
            self.spans.append(span)
        return span

    # ------------------------------------------------------------------ API
    def span(self, name: str, scope: str, trace: str | None = None,
             parent: int | None = None, attrs: dict | None = None,
             meta: dict | None = None) -> _SpanCtx:
        """Context-managed span: nests via a thread-local stack, so spans
        opened inside it (same thread) become its children automatically."""
        return _SpanCtx(self, self._record(name, scope, trace, parent,
                                           attrs, meta))

    def begin(self, name: str, scope: str, trace: str | None = None,
              parent: int | None = None, attrs: dict | None = None,
              meta: dict | None = None) -> Span | None:
        """Open a span WITHOUT touching the nesting stack — for spans that
        end on a different thread (e.g. a request span opened at submit and
        closed at completion). Close with ``end()``."""
        return self._record(name, scope, trace, parent, attrs, meta)

    def end(self, span: Span | None, attrs: dict | None = None) -> None:
        if span is None:
            return
        if attrs:
            span.attrs.update(attrs)
        span.wall_ns_end = time.perf_counter_ns()

    def emit(self, name: str, scope: str, trace: str | None = None,
             parent: int | None = None, attrs: dict | None = None,
             meta: dict | None = None) -> Span | None:
        """Record an already-finished (zero-wall-duration) span — used to
        project measured per-image accounts into the tree after the fact."""
        return self._record(name, scope, trace, parent, attrs, meta)

    # ------------------------------------------------------------- analysis
    def sorted_spans(self) -> list[Span]:
        with self._lock:
            return sorted(self.spans, key=lambda s: (s.trace, s.sid))

    def traces(self) -> dict[str, list[Span]]:
        out: dict[str, list[Span]] = {}
        for s in self.sorted_spans():
            out.setdefault(s.trace, []).append(s)
        return out

    def canonical(self, trace: str | None = None) -> list[dict]:
        """Deterministic form, sorted by (trace, sid) — the thing two seeded
        runs must agree on bit for bit (wall clocks and meta excluded)."""
        return [s.canonical() for s in self.sorted_spans()
                if trace is None or s.trace == trace]

    def fingerprint(self, trace: str | None = None) -> str:
        """SHA-256 over the canonical JSON — the repeatability check."""
        blob = json.dumps(self.canonical(trace), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    def roots(self, name: str) -> list[Span]:
        """All parentless spans with the given name (one per forward/batch)."""
        return [s for s in self.sorted_spans()
                if s.parent is None and s.name == name]

    def children(self, span: Span) -> list[Span]:
        return [s for s in self.sorted_spans()
                if s.trace == span.trace and s.parent == span.sid]

    def find(self, name: str, trace: str | None = None) -> list[Span]:
        return [s for s in self.sorted_spans() if s.name == name
                and (trace is None or s.trace == trace)]


# ---------------------------------------------------------- module recorder
_NULL = NullRecorder()
_recorder: NullRecorder | Tracer = _NULL


def get() -> NullRecorder | Tracer:
    return _recorder


def enabled() -> bool:
    return _recorder.enabled


def install(tracer: Tracer | NullRecorder | None):
    """Swap the module-level recorder; returns the previous one so callers
    can restore it (``install(None)`` restores the shared no-op)."""
    global _recorder
    prev = _recorder
    _recorder = tracer if tracer is not None else _NULL
    return prev


def span(name: str, scope: str, **kw):
    return _recorder.span(name, scope, **kw)


def begin(name: str, scope: str, **kw):
    return _recorder.begin(name, scope, **kw)


def end(span_obj, attrs: dict | None = None) -> None:
    _recorder.end(span_obj, attrs)


def emit(name: str, scope: str, **kw):
    return _recorder.emit(name, scope, **kw)


# ------------------------------------------------------------- device spans
def device_span(name: str):
    """A range of the torch profiler's trace around the work issued inside
    it, while a profiler runs; else the shared null context (the module
    docstring)."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _NULL_CTX


#: ``device_count``'s totals, and the device tensors whose sums are still to
#: be added to them; past ``_MAX_PENDING`` tensors they are added at once
_counts: dict[str, int] = {}
_pending: list = []
_count_lock = threading.Lock()
_MAX_PENDING = 256


def device_count(name: str, value) -> None:
    """Add ``value`` to the count ``name`` while a torch profiler runs: an
    int, or a tensor whose sum ``device_counts()`` adds (no kernel and no
    wait here)."""
    if not _profiler_enabled():
        return
    with _count_lock:
        if isinstance(value, torch.Tensor):
            _pending.append((name, value))
            if len(_pending) >= _MAX_PENDING:
                _fold()
        else:
            _counts[name] = _counts.get(name, 0) + int(value)


def _fold() -> None:
    """Add the pending tensors' sums to the counts (waits for the device);
    under ``_count_lock``."""
    for name, t in _pending:
        _counts[name] = _counts.get(name, 0) + int(t.sum())
    _pending.clear()


def device_counts() -> dict[str, int]:
    """The counts ``device_count`` took, every pending sum added."""
    with _count_lock:
        _fold()
        return dict(_counts)


def reset_device_counts() -> None:
    """Empty the counts and drop the pending sums."""
    with _count_lock:
        _counts.clear()
        _pending.clear()

"""Continuous-batching serving scheduler — the tier behind ``SNNServeEngine``.

One scheduler owns the whole request path the paper's §2.3 discipline wants
measured: an admission queue, deadline-aware micro-batch formation, N worker
lanes each owning a runtime built from a registry spec string
(``core.runtimes.make_runtime``), and per-request latency percentiles on top
of the accelerator/system scope split. The overflow→dense reroute and the
board cycle/energy account both live HERE — every front-end (the synchronous
``SNNServeEngine`` facade, the load bench's open/closed-loop clients) goes
through the same code path, so serving semantics cannot fork per caller.

Batch formation (the continuous-batching policy):
  * a batch OPENS when a lane picks up the oldest queued request;
  * it CLOSES at ``max_batch`` requests OR ``max_wait_us`` after opening,
    whichever comes first — bounded formation latency under light load,
    full batches under heavy load;
  * every batch is zero-padded to ``max_batch`` rows so each lane runs ONE
    compiled program regardless of traffic (the artifact's padded shapes).

Worker lanes:
  * ``workers >= 1`` — that many daemon threads, each with its OWN runtime
    instance (own lazy dense-fallback runtime, own board trace) and, on the
    card, its OWN CUDA stream: the wrappers and the host-to-device copies
    launch on the thread's current stream, so a lane enters its stream
    around every serve, and its accelerator scope waits on that stream, not
    the device (a device-wide synchronize would time the other lanes' work);
  * ``workers == 0`` — inline mode: no threads; ``drain()`` forms greedy
    ``max_batch``-sized batches and serves them on the calling thread via
    lane 0, on the caller's current stream, its scope ending with a
    device-wide synchronize. Deterministic batch count — the facade's
    flush() semantics.

Resilience (the fault-injection subsystem's consumer — ``repro_torch.faults``):
  * ``faults=`` takes a seeded ``FaultPlan`` (or its spec string) and splits
    it per lane; lane-fault fields drive a ``LaneFaultInjector`` around the
    serve call, static/dynamic fields ride into ``make_runtime``;
  * every lane runs a health state machine::

        healthy --fault detected--> suspect --scrub+rebuild OK--> healthy
                                       |                       (restarted)
                                       '--checks still fail--> quarantined
                                                                   |
                                             (degrade=True)        v
        degraded  <---- circuit breaker / quarantine ----  [dense fallback]

    a detected fault (worker exception, post-batch verification failure,
    watchdog timeout) requeues the in-flight batch (bounded per-request
    retries with exponential backoff; multi-request batches are re-queued
    ``solo`` so one poison request cannot re-kill its batchmates), then the
    lane is rebuilt from the pristine artifact and must pass its startup
    checks (artifact checksum + canary probes) to re-enter service;
  * detection is ``faults.detect``: artifact SHA-256 re-hash at lane
    startup / per batch, golden-canary probes per lane, board-trace
    cross-checks, membrane-ECC readout — every counter lands in ``stats()``;
  * the invariant all of this buys (the chaos bench's ``--check`` gate):
    every admitted request completes with either a bit-exact label or an
    explicit ``error`` — never a silent wrong answer, never a hang.

A failure of the kernels or of the card (``kernels.common.kernel_failure``:
a build, load or launch error, a CUDA runtime error, anything raised inside
a kernel wrapper) is not a lane fault: no lane is rebuilt or degraded around
it. The batch it hit and every queued request complete with an explicit
error, the worker lanes stop, ``submit`` raises from then on, and the
exception propagates to the caller of inline mode and of the constructor.

Bit-exactness holds regardless of batching: every runtime evaluates rows
independently, and pad rows never influence real ones, so a label served at
queue depth 60 equals the label served alone — the load bench's ``--check``
gate asserts exactly this against the software reference.

The port of ``repro.serving.scheduler``: the same state machine, counters
and failure semantics on the port's runtimes, on ``device``. Warm-up and
canary traffic are probes (``serve(..., probe=True)``): they never advance
a lane's fault-injector batch clock, so ``crash=0`` crashes the first real
batch. A lane's stream is synchronized before its runtime is dropped (scrub,
rebuild); a hung lane's thread is abandoned with its stream, and its late
completion is dropped by the ``lane.hung`` and ``attempts`` token checks.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core import ttfs
from repro_torch.core.artifact import Artifact
from repro_torch.core.events import pack_events_batched
from repro_torch.core.lowering import LoweredProgram, get_cache, lower
from repro_torch.core.runtimes import make_runtime
from repro_torch.faults.detect import (Canary, ecc_errors,
                                       runtime_integrity_errors, trace_errors)
from repro_torch.faults.plan import FaultPlan
from repro_torch.kernels.common import kernel_failure
from repro_torch.telemetry import trace as ttrace
from repro_torch.telemetry.metrics import (DEPTH_BUCKETS, LATENCY_BUCKETS_US,
                                           RECOVERY_BUCKETS_MS,
                                           MetricsRegistry)


class ServingError(RuntimeError):
    """A request completed with ``.error`` set; carries the request."""

    def __init__(self, request: "ServeRequest"):
        super().__init__(f"request {request.rid} failed after "
                         f"{request.attempts + 1} attempt(s): {request.error}")
        self.request = request


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs for the scheduler's detection/recovery machinery. Defaults are
    conservative: startup checks on, per-batch verification and the watchdog
    off (they cost a detector pass / a monitor thread per batch)."""

    max_retries: int = 2          # re-serves per request before giving up
    backoff_s: float = 0.005      # base of the exponential restart backoff
    watchdog_s: float | None = None   # per-batch serve deadline (threaded)
    breaker_threshold: int = 3    # lane faults before the circuit breaker
    startup_checks: bool = True   # checksum+canary at lane (re)commission
    verify: bool = False          # post-batch detectors BEFORE completion
    canary_every: int = 0         # also run canaries every N batches (0=off)
    degrade: bool = True          # quarantined/flapping lanes → dense path

    @classmethod
    def coerce(cls, obj) -> "ResilienceConfig":
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls(**obj)
        raise TypeError(f"cannot build a ResilienceConfig from "
                        f"{type(obj).__name__}")


@dataclasses.dataclass
class ServeRequest:
    """One admitted classification request, completed in place."""
    rid: int
    image: np.ndarray             # (N_in,) float32 in [0, 1]
    label: int | None = None      # filled at completion
    steps: int | None = None      # timesteps consumed (latency mode)
    fallback_dense: bool = False  # served via the dense reroute / degraded lane
    lane: int | None = None       # worker lane that served it
    t_submit: float = 0.0         # perf_counter at admission
    t_done: float = 0.0           # perf_counter at completion
    error: str | None = None      # set instead of label if serving failed
    attempts: int = 0             # re-serves consumed (0 = first try)
    solo: bool = False            # poison isolation: serve in a batch of one
    # telemetry handles (set only while a Tracer is installed): the request
    # root span opened at submit and the admission child closed at formation
    _span: object = dataclasses.field(default=None, repr=False, compare=False)
    _adm: object = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def latency_us(self) -> float:
        return 1e6 * (self.t_done - self.t_submit)


def _lane_stream(device: torch.device):
    """A new CUDA stream for a threaded lane on ``device``; ``None`` on the
    CPU, where nothing is launched."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


class _Lane:
    """One worker lane: a runtime built from the spec, plus the lane-local
    serve path (host encode and event packing, overflow reroute, board
    accounting) and the lane's health record. Each lane's counters are
    merged into the scheduler under its lock, so lanes themselves stay
    lock-free on the hot path.

    A threaded lane on the card owns a CUDA stream: its runtime is built,
    and every batch is served, with that stream current (the wrappers and
    the host-to-device copies launch on the current stream), and its
    accelerator scope ends on that stream alone. The inline lane
    (``stream=None``) stays on the caller's current stream and ends its
    scope with a device-wide synchronize."""

    def __init__(self, lane_id: int, program: LoweredProgram, spec: str,
                 kernel: str | None, latency_mode: bool,
                 plan: FaultPlan | None = None, stream=None):
        self.lane_id = lane_id
        # one lowering per artifact: the scheduler lowers once and every lane
        # (including watchdog-spawned replacements) reuses that PRISTINE
        # program — it backs scrub/reload; the serve-path scalars below come
        # from it, not from repeated meta reads
        self.program = program
        self.art = program.artifact
        self.device = program.device
        self.spec = spec
        self.family, _, _ = spec.partition("-")
        self.latency_mode = bool(latency_mode)
        self.plan = plan
        self.stream = stream
        kw = {"latency_mode": latency_mode}
        if kernel is not None:
            kw["kernel"] = kernel        # None = the family's own default
        if plan is not None:
            kw["faults"] = plan          # static/dynamic injection sites
        with self._on_stream():
            self.runtime = make_runtime(self.program, spec,
                                        device=self.device, **kw)
            self._sync()                 # its tensors are ready for any lane
        self._dense = None               # built lazily on first overflow
        self.T = self.program.T
        self.x_min = self.program.x_min
        self.e_max = self.program.e_max
        self.injector = None             # host-side fault site (lane faults)
        if plan is not None and plan.has_lane_faults:
            from repro_torch.faults.models import LaneFaultInjector
            self.injector = LaneFaultInjector(plan)
        # ------------------------------------------------- health record
        self.health = "healthy"          # healthy|suspect|quarantined|degraded
        self.fault_count = 0             # detected faults (feeds the breaker)
        self.restarts = 0                # successful scrub/rebuild cycles
        self.batches_served = 0          # serve attempts (canary cadence)
        self.busy_since: float | None = None   # watchdog: batch start time
        self.current: list | None = None       # watchdog: (request, token)s
        self.hung = False                # watchdog fired on this lane
        self.retired = False             # removed from service for good
        self.degraded = False            # circuit-broken to the dense path

    # ---------------------------------------------------------------- stream
    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _sync(self) -> None:
        """Wait for this lane's device work: its own stream when it has one,
        else the whole device (the inline lane). Also called before a lane's
        runtime may be dropped (scrub, rebuild): the caching allocator may
        hand a freed block of its tensors (a corrupted clone's program, a
        frame buffer) to another stream while this one still reads it."""
        if self.stream is not None:
            self.stream.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- serve path
    def serve(self, images: np.ndarray, k: int, probe: bool = False) -> dict:
        """Serve a zero-padded (max_batch, N_in) buffer whose first ``k``
        rows are real traffic; returns labels/steps/fallback plus the
        lane-local stat deltas for the scheduler to merge. ``probe`` marks
        canary traffic: it takes the same datapath but does not advance the
        host-fault injector's batch clock."""
        if self.injector is not None and not probe:
            self.injector.before_batch()
        with self._on_stream():
            if self.degraded:
                return self._serve_dense(images, k)
            if self.family == "accelerator" and self.runtime.mode == "event":
                return self._serve_event(images, k)
            return self._serve_forward(images, k)

    def _serve_forward(self, images: np.ndarray, k: int) -> dict:
        """board / reference / dense-accelerator path: forward(images)."""
        t0 = time.perf_counter()
        out = self.runtime.forward(images)
        self._sync()
        delta = {"accel_s": time.perf_counter() - t0,
                 "labels": out.labels.cpu().numpy(),
                 "steps": out.steps.cpu().numpy(),
                 "fallback": np.zeros(len(images), bool),
                 "overflow_fallbacks": 0}
        trace = getattr(self.runtime, "last_trace", None)
        if trace is not None:
            # board family: PL cycles / dynamic energy for the REAL rows only
            # (pad rows clock too, but they are not served traffic)
            delta["board_cycles"] = int(np.sum(trace.cycles[:k]))
            delta["board_nj"] = float(np.sum(trace.energy_nj[:k]))
            delta["board_stalls"] = int(np.sum(trace.stalls[:k]))
        return delta

    def _serve_event(self, images: np.ndarray, k: int) -> dict:
        """Packed-event accelerator path with the overflow→dense reroute.
        Encoding and packing run on the host; the frames reach the device
        in one copy."""
        times = ttfs.encode_ttfs(torch.from_numpy(images), self.T,
                                 self.x_min).numpy()
        frames = pack_events_batched(times, self.T, self.e_max,
                                     device=self.device)
        overflow = frames.overflow              # host flags, no device read

        t0 = time.perf_counter()
        out = self.runtime.forward(frames=frames,
                                   latency_mode=self.latency_mode,
                                   check_overflow=False)
        self._sync()
        accel_s = time.perf_counter() - t0
        labels = out.labels.cpu().numpy()       # writable host copies
        steps = out.steps.cpu().numpy()         # (reroute rows are patched)

        bad = np.nonzero(overflow[:k])[0]
        if bad.size:
            # overflow policy: reroute those rows through the dense
            # time-batched path (same artifact, same semantics, no E_max
            # cap). Runs on the full fixed-shape padded buffer so the dense
            # program compiles once, not per distinct overflow-row count.
            self._ensure_dense()
            t0 = time.perf_counter()
            dense_out = self._dense.forward(images=images)
            self._sync()
            accel_s += time.perf_counter() - t0
            labels[bad] = dense_out.labels.cpu().numpy()[bad]
            steps[bad] = dense_out.steps.cpu().numpy()[bad]
        return {"accel_s": accel_s, "labels": labels, "steps": steps,
                "fallback": overflow, "overflow_fallbacks": int(bad.size)}

    # ----------------------------------------------------- degraded fallback
    def _ensure_dense(self) -> None:
        if self._dense is None:
            # built from the lane's PRISTINE lowered program — a degraded
            # lane must not inherit the faulted datapath it is escaping
            # (static faults corrupt a clone inside make_runtime, never
            # the shared program). Plain PyTorch, the JAX package's jnp
            # default; built on the lane's stream and waited for, as the
            # lane's runtime is
            with self._on_stream():
                self._dense = make_runtime(self.program, "accelerator-batch",
                                           device=self.device)
                self._sync()

    def _serve_dense(self, images: np.ndarray, k: int) -> dict:
        """Circuit-broken path: the whole batch through the dense
        time-batched runtime. Correct labels, none of the event-path
        speed — graceful degradation, flagged per request."""
        self._ensure_dense()
        t0 = time.perf_counter()
        out = self._dense.forward(images=images)
        self._sync()
        return {"accel_s": time.perf_counter() - t0,
                "labels": out.labels.cpu().numpy(),
                "steps": out.steps.cpu().numpy(),
                "fallback": np.ones(len(images), bool),
                "overflow_fallbacks": 0}


class ServingScheduler:
    """Admission queue + deadline-aware micro-batching + N worker lanes.

    ``submit()`` is thread-safe and returns immediately with a request id;
    ``result(rid)`` blocks one caller until its request completes (the
    closed-loop client API) and raises ``ServingError`` if the request
    completed with ``.error`` set; ``drain()`` blocks until the queue is
    empty and returns every completed-but-unclaimed request (the synchronous
    facade API — errored requests are returned, not raised). ``stats()``
    reports both measurement scopes plus request-latency percentiles,
    queue-depth stats, and every fault-detection/recovery counter;
    ``reset_stats()`` zeroes them (e.g. after a warmup pass, so compile time
    does not pollute percentiles).

    ``faults=`` injects a seeded ``faults.plan.FaultPlan`` (or its spec
    string, e.g. ``"crash=0,lanes=0,seed=7"``); ``resilience=`` tunes the
    detection/recovery machinery (see ``ResilienceConfig``);
    ``canary_pool=`` supplies held-out images for the golden-canary
    detector (enables canary checks at lane startup/restart).

    Everything runs on ``device`` (default ``"cuda"``, which raises without
    a card; pass ``"cpu"`` for the kernels' plain versions). Threaded lanes
    on the card each serve on a CUDA stream of their own."""

    def __init__(self, artifact: Artifact | LoweredProgram, *,
                 spec: str = "accelerator-event",
                 workers: int = 0, max_batch: int = 64,
                 max_wait_us: float = 2000.0, kernel: str | None = None,
                 latency_mode: bool = False, faults=None, resilience=None,
                 canary_pool: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        if workers < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.spec = spec
        self.family = spec.partition("-")[0]
        self.kernel = kernel
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)
        self.workers = int(workers)
        self.latency_mode = bool(latency_mode)
        # lower once; every lane (and watchdog replacement) shares this
        # program, so rebuilds skip straight to the cached compiled bundle.
        # An already-lowered program passes through (the multi-host follower
        # path hands the scheduler a deserialized program directly).
        self.program = lower(artifact, device=device)
        self.device = self.program.device
        self.art = self.program.artifact
        self.n_in = self.program.n_in
        self.plan = FaultPlan.coerce(faults)
        self.resilience = ResilienceConfig.coerce(resilience)

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._admission: collections.deque[ServeRequest] = collections.deque()
        self._completed: dict[int, ServeRequest] = {}
        self._claims: set[int] = set()       # rids owned by result() waiters
        self._outstanding: set[int] = set()  # submitted, not yet completed
        self._requests: dict[int, ServeRequest] = {}  # every outstanding req
        self._pending = 0
        self._next_rid = 0
        self._stop = False
        self._all_quarantined = False
        self._fatal: BaseException | None = None   # a kernel failure halted it
        # every scheduler counter/gauge/histogram and the typed fault ledger
        # live in ONE registry (one internal lock), so stats() is a
        # consistent snapshot — no torn reads while lanes keep mutating
        self.metrics = MetricsRegistry()
        self._batch_seq = 0
        self.reset_stats()

        self.canary: Canary | None = None
        if canary_pool is not None or self.resilience.canary_every:
            self.canary = Canary.from_program(self.program, pool=canary_pool)
        self.lanes = [self._commission(i) for i in range(max(1, workers))]
        if all(lane.retired for lane in self.lanes):
            # persistent faults + degrade=False can retire every lane at
            # commission time: refuse admission instead of hanging drain()
            self._all_quarantined = True
        self._lane_gens = [0] * len(self.lanes)
        self._threads = [
            threading.Thread(target=self._worker, args=(lane.lane_id, 0),
                             daemon=True, name=f"serve-lane-{lane.lane_id}")
            for lane in (self.lanes if workers else [])]
        for t in self._threads:
            t.start()
        self._watchdog_thread = None
        if self._threads and self.resilience.watchdog_s:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, daemon=True, name="serve-watchdog")
            self._watchdog_thread.start()

    # ---------------------------------------------------------------- client
    def submit(self, image: np.ndarray) -> int:
        image = np.asarray(image, np.float32)
        if image.shape != (self.n_in,):
            # reject malformed traffic at admission — a bad shape must never
            # reach a lane where it would poison a whole batch
            raise ValueError(f"image must have shape ({self.n_in},), got "
                             f"{image.shape}")
        with self._cv:
            if self._fatal is not None:
                raise RuntimeError(f"scheduler halted by a kernel failure: "
                                   f"{self._fatal}") from self._fatal
            if self._stop:
                raise RuntimeError("scheduler is closed")
            if self._all_quarantined:
                raise RuntimeError("all lanes quarantined — no serving "
                                   "capacity left (degrade=False)")
            rid = self._next_rid
            self._next_rid += 1
            req = ServeRequest(rid, image, t_submit=time.perf_counter())
            rec = ttrace.get()
            if rec.enabled:
                # request root span: opened here, closed by the completion
                # choke point (possibly on another thread) — begin/end, not
                # the context manager
                req._span = rec.begin("request", "system",
                                      trace=f"req-{rid:08d}",
                                      attrs={"rid": rid})
                if req._span is not None:
                    req._adm = rec.begin("admission", "system",
                                         trace=req._span.trace,
                                         parent=req._span.sid)
            self._admission.append(req)
            self._outstanding.add(rid)
            self._requests[rid] = req
            self._pending += 1
            self._sample_depth()
            self._cv.notify_all()
            return rid

    def result(self, rid: int, timeout: float | None = None) -> ServeRequest:
        """Block until request ``rid`` completes; pops and returns it (the
        closed-loop client API). Raises ``ServingError`` (carrying the
        request) if it completed with ``.error`` set. Inline mode serves the
        queue first. The rid is CLAIMED while waiting — a concurrent
        ``drain()`` will not return it out from under this caller — and a
        rid that is neither outstanding nor completed (already drained or
        returned) raises KeyError instead of blocking forever."""
        with self._cv:
            if rid not in self._completed and rid not in self._outstanding:
                raise KeyError(f"request {rid} is not outstanding — already "
                               "claimed by drain()/result() or never "
                               "submitted")
            self._claims.add(rid)
        try:
            if not self._threads:
                self._drain_inline()
            deadline = (None if timeout is None
                        else time.perf_counter() + timeout)
            with self._cv:
                while rid not in self._completed:
                    remaining = (None if deadline is None
                                 else deadline - time.perf_counter())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(f"request {rid} not completed "
                                           f"within {timeout}s")
                    self._cv.wait(timeout=remaining)
                req = self._completed.pop(rid)
        finally:
            with self._cv:
                self._claims.discard(rid)
        if req.error is not None:
            raise ServingError(req)
        return req

    def drain(self) -> dict[int, ServeRequest]:
        """Serve/await everything queued; pop and return every completed
        request not claimed by a ``result()`` waiter."""
        if not self._threads:
            self._drain_inline()
        with self._cv:
            while self._pending:
                self._cv.wait()
            done = {rid: r for rid, r in self._completed.items()
                    if rid not in self._claims}
            for rid in done:
                del self._completed[rid]
            return done

    def close(self, drain: bool = False) -> None:
        """Stop the worker lanes. Batches in flight finish. With
        ``drain=True`` the queued backlog is served first (graceful drain);
        by default it is NOT served — its requests complete immediately with
        ``error="scheduler closed"``. Either way every admitted request is
        completed: no waiter hangs, nothing is dropped silently."""
        if drain and not self._stop:
            if self._threads:
                with self._cv:
                    while (self._pending
                           and any(t.is_alive() for t in self._threads)):
                        self._cv.wait(timeout=0.05)
            else:
                self._drain_inline()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=30.0)
        with self._cv:
            now = time.perf_counter()
            self._admission.clear()
            # queued AND in-flight-on-a-dead-lane: everything still
            # outstanding is error-completed so no submitter is stranded
            for rid in sorted(self._outstanding):
                r = self._requests[rid]
                r.error = "scheduler closed"
                r.t_done = now
                self._complete_locked(r)
                self._pending -= 1
            self._cv.notify_all()

    # completed-but-unclaimed backlog bound: past this, the oldest unclaimed
    # results are abandoned (counted in stats) instead of pinning their
    # request images forever in a server whose callers never drain()
    COMPLETED_WINDOW = 65536

    def _complete_locked(self, r: ServeRequest) -> None:
        """Caller holds the lock: publish a finished request, releasing its
        outstanding slot and bounding the unclaimed backlog. This is the ONE
        place a request span closes — success, error, and close() paths all
        funnel through here, so no request span can leak open."""
        sp = r._span
        if sp is not None:
            rec = ttrace.get()
            if r.error is not None:
                rec.emit("complete", "system", trace=sp.trace, parent=sp.sid,
                         attrs={"error": r.error}, meta={"lane": r.lane})
            else:
                rec.emit("complete", "system", trace=sp.trace, parent=sp.sid,
                         attrs={"label": r.label, "steps": r.steps,
                                "fallback": r.fallback_dense,
                                "attempts": r.attempts},
                         meta={"lane": r.lane})
            rec.end(sp)
            r._span = r._adm = None
        self._outstanding.discard(r.rid)
        self._requests.pop(r.rid, None)
        self._completed[r.rid] = r
        while len(self._completed) > self.COMPLETED_WINDOW:
            victim = next((rid for rid in self._completed
                           if rid not in self._claims), None)
            if victim is None:               # everything left has a waiter
                break
            del self._completed[victim]
            self.metrics.inc("abandoned_results")

    def _fail_locked(self, r: ServeRequest, tok: int, msg: str,
                     lane_id: int | None, now: float) -> None:
        """Caller holds the lock: error-complete one request (token-guarded
        so a stale thread cannot double-complete a requeued request)."""
        if r.rid not in self._outstanding or r.attempts != tok:
            return
        r.error = msg
        r.lane = lane_id
        r.t_done = now
        self._complete_locked(r)
        self._pending -= 1
        self.metrics.inc("errors")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------- batch formation
    def _form_batch(self) -> list[ServeRequest] | None:
        """Blocking formation for worker lanes: open on the oldest queued
        request, close at max_batch OR max_wait_us — whichever first.
        ``solo`` requests (poison isolation after a batch failure) always
        form a batch of one."""
        with self._cv:
            while not self._admission and not self._stop:
                self._cv.wait()
            if self._stop:                   # no NEW batches after close():
                return None                  # the backlog is failed, not served
            batch = [self._admission.popleft()]
            if batch[0].solo:
                self._sample_depth()
                return batch
            deadline = time.perf_counter() + self.max_wait_us * 1e-6
            while len(batch) < self.max_batch:
                if self._admission:
                    if self._admission[0].solo:
                        break                # isolation batch forms alone
                    batch.append(self._admission.popleft())
                    continue
                remaining = deadline - time.perf_counter()
                if self._stop or remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            self._sample_depth()
            return batch

    def _worker(self, lane_id: int, gen: int) -> None:
        try:
            while True:
                with self._cv:
                    if self._lane_gens[lane_id] != gen:
                        return   # superseded by a watchdog replacement thread
                    lane = self.lanes[lane_id]
                    if lane.retired or lane.hung:
                        # a hung lane's batch was requeued and its thread
                        # is being replaced: it takes no new batch, whose
                        # completion its hung flag would drop
                        return
                batch = self._form_batch()
                if batch is None:
                    return
                self._serve_batch(lane, batch)
        except Exception as e:  # noqa: BLE001 — kernel failures only
            if not kernel_failure(e):
                raise
            self._halt(e, [], lane_id)

    def _drain_inline(self) -> None:
        """Inline mode: greedy max_batch-sized batches on the caller thread
        (deterministic batch count — the facade's flush() semantics)."""
        while True:
            with self._cv:
                if not self._admission:
                    return
                batch = []
                while self._admission and len(batch) < self.max_batch:
                    batch.append(self._admission.popleft())
            self._serve_batch(self.lanes[0], batch)

    # -------------------------------------------------------------- serving
    def _serve_batch(self, lane: _Lane, batch: list[ServeRequest]) -> None:
        t0 = time.perf_counter()
        k = len(batch)
        pairs = [(r, r.attempts) for r in batch]   # completion tokens
        lane.current = pairs
        lane.busy_since = t0
        lane.batches_served += 1
        rec = ttrace.get()
        bspan = lspan = None
        if rec.enabled:
            with self._lock:
                seq = self._batch_seq
                self._batch_seq += 1
            bspan = rec.begin("batch", "system", trace=f"batch-{seq:06d}",
                              attrs={"k": k, "max_batch": self.max_batch},
                              meta={"lane": lane.lane_id,
                                    "rids": [r.rid for r in batch]})
            for r, _ in pairs:
                rec.end(r._adm)     # admission ends where the batch forms
                if r._span is not None:
                    rec.emit("batch-form", "system", trace=r._span.trace,
                             parent=r._span.sid, meta={"batch": seq})
            if bspan is not None:
                lspan = rec.begin("lane", "system", trace=bspan.trace,
                                  parent=bspan.sid,
                                  meta={"lane": lane.lane_id,
                                        "health": lane.health})
        failure: str | None = None
        exc: BaseException | None = None
        delta = None
        try:
            images = np.zeros((self.max_batch, self.n_in), np.float32)
            for j, r in enumerate(batch):
                images[j] = r.image          # zero-pad to the fixed shape
            if lspan is not None:
                # context-managed so the runtime's own spans (board.forward,
                # accel.kernel, …) nest under this batch's tree
                with rec.span("runtime", "system", trace=bspan.trace,
                              parent=lspan.sid, meta={"spec": lane.spec}):
                    delta = lane.serve(images, k)
            else:
                delta = lane.serve(images, k)
            if self.resilience.verify:
                errs = self._verify_errors(lane, images)
                if errs:
                    failure = "detected fault: " + "; ".join(errs)
        except Exception as e:  # noqa: BLE001 — any serve failure is a fault
            exc = e
            failure = f"{type(e).__name__}: {e}"
        finally:
            # under the lock: the watchdog reads busy_since and then current
            # in one critical section, and a batch that ends between the two
            # reads would be neither requeued nor completed
            with self._cv:
                lane.busy_since = None
                lane.current = None
        now = time.perf_counter()
        rec.end(lspan)
        if bspan is not None:
            rec.end(bspan, attrs={"failed": failure is not None})

        if exc is not None and kernel_failure(exc):
            self._halt(exc, pairs, lane.lane_id)
            raise exc
        if failure is not None:
            if not self._threads:
                # inline mode: no retry machinery — complete with .error so
                # nothing strands, then surface to the synchronous caller
                with self._cv:
                    self.metrics.inc("lane_faults")
                    for r, tok in pairs:
                        self._fail_locked(r, tok, failure, lane.lane_id, now)
                    self._cv.notify_all()
                if exc is not None:
                    raise exc
                raise ServingError(batch[0])
            self._handle_lane_fault(lane, pairs, failure)
            return

        with self._cv:
            if self.lanes[lane.lane_id] is not lane or lane.hung:
                return  # superseded mid-serve; the watchdog requeued these
            completed = 0
            m = self.metrics
            for j, (r, tok) in enumerate(pairs):
                if r.rid not in self._outstanding or r.attempts != tok:
                    continue                 # stale: requeued/completed away
                r.label = int(delta["labels"][j])
                r.steps = int(delta["steps"][j])
                r.fallback_dense = bool(delta["fallback"][j])
                r.lane = lane.lane_id
                r.t_done = now
                self._complete_locked(r)
                m.observe("request_latency_us", r.latency_us,
                          LATENCY_BUCKETS_US)
                completed += 1
            self._pending -= completed
            m.inc("images_out", completed)
            m.inc("batches")
            m.observe("batch_fill", k, DEPTH_BUCKETS)
            m.inc("accel_s", delta["accel_s"])
            m.inc("system_s", now - t0)
            m.inc("overflow_fallbacks", delta["overflow_fallbacks"])
            m.inc("board_cycles", delta.get("board_cycles", 0))
            m.inc("board_nj", delta.get("board_nj", 0.0))
            m.inc("board_stalls", delta.get("board_stalls", 0))
            self._cv.notify_all()

    # ------------------------------------------------------------- detection
    def _verify_errors(self, lane: _Lane, images: np.ndarray) -> list[str]:
        """Post-batch detector pass, run BEFORE completion so a corrupted
        label can never escape to a caller: membrane-ECC readout, board
        trace cross-check, artifact checksum, periodic canaries."""
        if lane.degraded:
            return []                        # dense fallback: clean by build
        m = self.metrics
        errs = ecc_errors(lane.runtime)
        if errs:
            m.inc("ecc_detected")
            m.event("detector", kind="ecc", lane=lane.lane_id, n=len(errs))
        t_errs = trace_errors(lane.runtime, images)
        m.inc("trace_checks")
        if t_errs:
            m.inc("trace_failures")
            m.event("detector", kind="trace", lane=lane.lane_id,
                    n=len(t_errs))
        errs += t_errs
        i_errs = runtime_integrity_errors(lane.runtime)
        m.inc("integrity_checks")
        if i_errs:
            m.inc("integrity_failures")
            m.event("detector", kind="checksum", lane=lane.lane_id,
                    n=len(i_errs))
        errs += i_errs
        every = self.resilience.canary_every
        if (self.canary is not None and every
                and lane.batches_served % every == 0):
            errs += self._canary_errors(lane)
        return errs

    def _canary_errors(self, lane: _Lane) -> list[str]:
        """Serve the pinned canary probes through the lane's OWN datapath
        and compare against the reference labels built at startup."""
        got: list[int] = []
        try:
            imgs = self.canary.images
            for i in range(0, len(imgs), self.max_batch):
                chunk = imgs[i:i + self.max_batch]
                buf = np.zeros((self.max_batch, self.n_in), np.float32)
                buf[:len(chunk)] = chunk
                delta = lane.serve(buf, len(chunk), probe=True)
                got.extend(int(x) for x in delta["labels"][:len(chunk)])
            errs = self.canary.mismatches(got)
        except Exception as e:  # noqa: BLE001 — a crash IS a failed probe
            if kernel_failure(e):
                raise
            errs = [f"canary probe serve failed: {type(e).__name__}: {e}"]
        self.metrics.inc("canary_checks")
        if errs:
            self.metrics.inc("canary_failures")
            self.metrics.event("detector", kind="canary", lane=lane.lane_id,
                               n=len(errs))
        return errs

    def _startup_errors(self, lane: _Lane) -> list[str]:
        """Commission / quarantine re-entry checks: artifact checksum on the
        lane's in-memory copy, then the canary probes (when built)."""
        errs = runtime_integrity_errors(lane.runtime)
        self.metrics.inc("integrity_checks")
        if errs:
            self.metrics.inc("integrity_failures")
            self.metrics.event("detector", kind="checksum",
                               lane=lane.lane_id, n=len(errs))
        if self.canary is not None:
            errs = errs + self._canary_errors(lane)
        return errs

    def _warm_errors(self, lane: _Lane) -> list[str]:
        """Prime the lane's compiled programs with a zero probe batch BEFORE
        it enters service — the watchdog must never mistake first-serve
        compilation for a hang (a lane is 'ready' only once programmed, as a
        bitstream load would be). A warmup crash is a commissioning fault."""
        try:
            lane.serve(np.zeros((self.max_batch, self.n_in), np.float32), 0,
                       probe=True)
            return []
        except Exception as e:  # noqa: BLE001 — failed warmup = failed lane
            if kernel_failure(e):
                raise
            return [f"lane warmup failed: {type(e).__name__}: {e}"]

    # -------------------------------------------------------------- recovery
    def _transition(self, lane: _Lane, to: str, reason: str) -> None:
        """Move a lane's health state, recording the transition as a typed
        event in the ledger (no event for a self-transition)."""
        if lane.health != to:
            self.metrics.event("lane_transition", lane=lane.lane_id,
                               frm=lane.health, to=to, reason=reason)
        lane.health = to

    def _new_lane(self, lane_id: int, plan: FaultPlan | None) -> _Lane:
        """A lane over the pristine program; a threaded lane (every lane
        built for ``workers >= 1``, replacements included) on a stream of
        its own."""
        stream = _lane_stream(self.device) if self.workers else None
        return _Lane(lane_id, self.program, self.spec, self.kernel,
                     self.latency_mode, plan, stream)

    def _commission(self, lane_id: int) -> _Lane:
        """Build lane ``lane_id`` and gate it through the startup checks: a
        lane that fails (e.g. an SEU already in its BRAM image) is scrubbed
        and rebuilt once; if the fault survives the rebuild (persistent), it
        is quarantined — degraded to the dense path when allowed."""
        plan = self.plan.for_lane(lane_id) if self.plan is not None else None
        lane = self._new_lane(lane_id, plan)
        errs = self._warm_errors(lane)
        if not errs and self.resilience.startup_checks:
            errs = self._startup_errors(lane)
        if not errs:
            return lane
        t0 = time.perf_counter()
        self.metrics.inc("lane_faults")
        lane._sync()
        fresh = self._new_lane(
            lane_id, plan.after_scrub() if plan is not None else None)
        fresh.fault_count = 1
        fresh.restarts = 1
        errs = self._warm_errors(fresh)
        if not errs and self.resilience.startup_checks:
            errs = self._startup_errors(fresh)
        if not errs:
            self.metrics.inc("lane_restarts")
            self.metrics.inc("recoveries")
            self.metrics.observe("recovery_ms",
                                 1e3 * (time.perf_counter() - t0),
                                 RECOVERY_BUCKETS_MS)
            return fresh
        self._transition(fresh, "quarantined", "startup checks failed")
        self.metrics.inc("quarantines")
        if self.resilience.degrade:
            self._degrade(fresh)
        else:
            fresh.retired = True
        return fresh

    def _handle_lane_fault(self, lane: _Lane, pairs: list, reason: str
                           ) -> None:
        """Threaded fault path: requeue-or-fail the batch, then take the
        lane through suspect → (restarted | quarantined | degraded)."""
        t_fault = time.perf_counter()
        with self._cv:
            if self.lanes[lane.lane_id] is not lane or lane.hung:
                self._cv.notify_all()
                return  # the watchdog superseded this lane mid-serve
            self._transition(lane, "suspect", "fault detected")
            lane.fault_count += 1
            self.metrics.inc("lane_faults")
            self._requeue_locked(pairs, reason, lane.lane_id)
            self._cv.notify_all()
        self._recover_lane(lane, t_fault)

    def _requeue_locked(self, pairs: list, reason: str, lane_id: int) -> None:
        """Caller holds the lock: push a failed batch's requests back to the
        FRONT of the admission queue (bounded retries; batches of more than
        one requeue ``solo`` so a poison request cannot re-kill batchmates)."""
        now = time.perf_counter()
        isolate = len(pairs) > 1
        for r, tok in reversed(pairs):
            if r.rid not in self._outstanding or r.attempts != tok:
                continue                     # stale token: already handled
            r.attempts += 1
            if r.attempts > self.resilience.max_retries:
                r.attempts -= 1              # restore for the error message
                self._fail_locked(r, tok, f"{reason} (gave up after "
                                  f"{r.attempts + 1} attempts)", lane_id, now)
                continue
            if isolate:
                r.solo = True
            if r._span is not None:
                ttrace.get().emit("requeue", "system", trace=r._span.trace,
                                  parent=r._span.sid,
                                  attrs={"attempt": r.attempts},
                                  meta={"lane": lane_id,
                                        "reason": reason[:120]})
            self._admission.appendleft(r)
            self.metrics.inc("requeued")

    def _recover_lane(self, lane: _Lane, t_fault: float) -> None:
        """Scrub/reload recovery: exponential backoff, rebuild the lane's
        runtime from the pristine artifact, re-gate through the startup
        checks. Flapping lanes hit the circuit breaker and degrade."""
        res = self.resilience
        time.sleep(min(res.backoff_s * (2 ** min(lane.restarts, 6)), 1.0))
        if res.degrade and lane.fault_count >= res.breaker_threshold:
            self._degrade(lane)              # circuit breaker: stop flapping
            return
        fresh = None
        errs: list[str] = []
        try:
            lane._sync()
            fresh = self._new_lane(
                lane.lane_id,
                lane.plan.after_scrub() if lane.plan is not None else None)
            errs = self._warm_errors(fresh)
            if not errs and res.startup_checks:
                errs = self._startup_errors(fresh)
        except Exception as e:  # noqa: BLE001 — a failed rebuild quarantines
            if kernel_failure(e):
                raise
            errs = [f"lane rebuild failed: {type(e).__name__}: {e}"]
        with self._cv:
            if self.lanes[lane.lane_id] is not lane:
                return
            if fresh is not None and not errs:
                fresh.fault_count = lane.fault_count
                fresh.restarts = lane.restarts + 1
                self.lanes[lane.lane_id] = fresh
                self.metrics.inc("lane_restarts")
                self.metrics.inc("recoveries")
                self.metrics.observe(
                    "recovery_ms", 1e3 * (time.perf_counter() - t_fault),
                    RECOVERY_BUCKETS_MS)
                self.metrics.event("lane_transition", lane=lane.lane_id,
                                   frm="suspect", to="healthy",
                                   reason="scrub+rebuild passed checks")
                self._cv.notify_all()
                return
            self._transition(lane, "quarantined", "rebuild failed checks")
            self.metrics.inc("quarantines")
            self._cv.notify_all()
        if res.degrade:
            self._degrade(lane)
        else:
            self._retire(lane)

    def _degrade(self, lane: _Lane) -> None:
        """Circuit breaker: route the lane's traffic through the dense
        fallback runtime (built from the pristine artifact) and disarm any
        host-fault injector — correctness preserved, event path abandoned."""
        try:
            lane._ensure_dense()
        except Exception as e:  # noqa: BLE001 — no fallback either: retire
            if kernel_failure(e):
                raise
            self._retire(lane)
            return
        with self._cv:
            lane.degraded = True
            self._transition(lane, "degraded", "circuit breaker")
            self.metrics.event("breaker_trip", lane=lane.lane_id,
                               fault_count=lane.fault_count)
            if lane.injector is not None:
                lane.injector.disarm()
            self.metrics.inc("breaker_degraded")
            self._cv.notify_all()

    def _halt(self, exc: BaseException, pairs: list, lane_id: int | None
              ) -> None:
        """A kernel failure: complete the batch it hit (``pairs``) and every
        queued request with an explicit error, and stop the worker lanes;
        ``submit`` raises from now on. Nothing is requeued, rebuilt or
        degraded: a lane would only fail again, or serve around the kernels
        on the dense path."""
        msg = f"kernel failure: {type(exc).__name__}: {exc}"
        with self._cv:
            if self._fatal is None:
                self._fatal = exc
            self._stop = True
            now = time.perf_counter()
            for r, tok in pairs:
                self._fail_locked(r, tok, msg, lane_id, now)
            while self._admission:
                r = self._admission.popleft()
                self._fail_locked(r, r.attempts, msg, None, now)
            self._cv.notify_all()

    def _retire(self, lane: _Lane) -> None:
        """Remove a lane from service for good. If that was the last one,
        fail the queue rather than letting it hang forever. (During
        ``__init__`` commissioning ``self.lanes`` does not exist yet; the
        all-retired case there is handled after the lane list is built.)"""
        with self._cv:
            lane.retired = True
            self._transition(lane, "quarantined", "retired from service")
            lanes = getattr(self, "lanes", None)
            if lanes is not None and all(ln.retired for ln in lanes) \
                    and getattr(self, "_threads", None):
                self._all_quarantined = True
                now = time.perf_counter()
                while self._admission:
                    r = self._admission.popleft()
                    self._fail_locked(r, r.attempts,
                                      "all lanes quarantined", None, now)
            self._cv.notify_all()

    # -------------------------------------------------------------- watchdog
    def _watchdog_loop(self) -> None:
        """Monitor thread: a lane whose batch exceeds ``watchdog_s`` is
        declared hung — its in-flight requests are requeued immediately and
        a replacement lane (fresh thread, scrubbed runtime) takes its slot;
        the hung thread's eventual results are discarded by token checks."""
        w = float(self.resilience.watchdog_s)
        tick = max(w / 4.0, 0.002)
        while True:
            victims = []
            with self._cv:
                if self._stop:
                    return
                now = time.perf_counter()
                for lane in list(self.lanes):
                    b = lane.busy_since
                    if b is not None and now - b > w and not lane.hung:
                        lane.hung = True
                        self._transition(lane, "suspect", "watchdog timeout")
                        lane.fault_count += 1
                        self.metrics.inc("lane_faults")
                        self.metrics.inc("watchdog_timeouts")
                        self._requeue_locked(
                            lane.current or [],
                            f"watchdog: batch exceeded {w:.3f}s on lane "
                            f"{lane.lane_id}", lane.lane_id)
                        victims.append((lane, now))
                if victims:
                    self._cv.notify_all()
            try:
                for lane, t_fault in victims:
                    self._replace_hung_lane(lane, t_fault)
            except Exception as e:  # noqa: BLE001 — kernel failures only
                if not kernel_failure(e):
                    raise
                self._halt(e, [], None)
                return
            time.sleep(tick)

    def _replace_hung_lane(self, lane: _Lane, t_fault: float) -> None:
        fresh = None
        errs: list[str] = []
        try:
            # the hung thread still owns the old lane and its stream; the
            # replacement gets a stream of its own
            fresh = self._new_lane(
                lane.lane_id,
                lane.plan.after_scrub() if lane.plan is not None else None)
            errs = self._warm_errors(fresh)
            if not errs and self.resilience.startup_checks:
                errs = self._startup_errors(fresh)
        except Exception as e:  # noqa: BLE001
            if kernel_failure(e):
                raise
            errs = [f"lane rebuild failed: {type(e).__name__}: {e}"]
        spawn = None
        with self._cv:
            if self.lanes[lane.lane_id] is not lane:
                return
            if fresh is not None and not errs:
                fresh.fault_count = lane.fault_count
                fresh.restarts = lane.restarts + 1
                self.lanes[lane.lane_id] = fresh
                self._lane_gens[lane.lane_id] += 1
                gen = self._lane_gens[lane.lane_id]
                self.metrics.inc("lane_restarts")
                self.metrics.inc("recoveries")
                self.metrics.observe(
                    "recovery_ms", 1e3 * (time.perf_counter() - t_fault),
                    RECOVERY_BUCKETS_MS)
                self.metrics.event("lane_transition", lane=lane.lane_id,
                                   frm="suspect", to="healthy",
                                   reason="hung lane replaced")
                spawn = threading.Thread(
                    target=self._worker, args=(lane.lane_id, gen),
                    daemon=True, name=f"serve-lane-{lane.lane_id}r{gen}")
                self._threads.append(spawn)
            else:
                self._transition(lane, "quarantined",
                                 "hung-lane replacement failed checks")
                self.metrics.inc("quarantines")
            self._cv.notify_all()
        if spawn is not None:
            spawn.start()
        else:
            # the hung thread still owns the old lane object, so the breaker
            # cannot reuse it — a failed replacement retires the slot
            self._retire(lane)

    # ---------------------------------------------------------------- stats
    def _sample_depth(self) -> None:
        d = len(self._admission)
        self.metrics.observe("queue_depth", d, DEPTH_BUCKETS)
        self.metrics.set_max("queue_depth_peak", d)

    # percentile window: enough to hold any bench run exactly, bounded so a
    # long-running server cannot leak memory (percentiles become a sliding
    # window over the most recent requests past this point)
    LATENCY_WINDOW = 65536

    def reset_stats(self) -> None:
        """Zero the registry in place (post-warmup semantics) and eagerly
        register the fixed-bucket histograms so their boundaries are pinned
        once, at reset, not wherever the first observation lands."""
        m = self.metrics
        m.reset()
        m.histogram("request_latency_us", LATENCY_BUCKETS_US,
                    window=self.LATENCY_WINDOW)
        m.histogram("recovery_ms", RECOVERY_BUCKETS_MS)
        m.histogram("batch_fill", DEPTH_BUCKETS)
        m.histogram("queue_depth", DEPTH_BUCKETS)

    def stats(self) -> dict:
        """Legacy-shaped view over one consistent ``metrics.snapshot()`` —
        every key the pre-telemetry scheduler reported, same semantics, but
        all totals were true at the same instant (no torn reads)."""
        with self._lock:
            snap = self.metrics.snapshot()
            lane_health = [lane.health for lane in self.lanes]
        n = int(snap.get("images_out", 0))
        # ONE denominator guard for every per-image rate (board and
        # accelerator branches used to disagree: `if n` vs `max(1, n)`)
        def per_image(x):
            return x / n if n else 0.0
        accel_s = float(snap.get("accel_s", 0.0))
        system_s = float(snap.get("system_s", 0.0))
        batches = int(snap.get("batches", 0))
        st = {
            "spec": self.spec,
            "device": str(self.device),
            "workers": self.workers,
            "max_batch": self.max_batch,
            "max_wait_us": self.max_wait_us,
            "accelerator_s": accel_s,
            "system_s": system_s,
            "host_overhead_s": max(0.0, system_s - accel_s),
            "images_out": n,
            "overflow_fallbacks": int(snap.get("overflow_fallbacks", 0)),
            "errors": int(snap.get("errors", 0)),
            "abandoned_results": int(snap.get("abandoned_results", 0)),
            "batches": batches,
            "accel_us_per_image": per_image(1e6 * accel_s),
            "system_us_per_image": per_image(1e6 * system_s),
            "p50_latency_us": snap.get("request_latency_us_p50", 0.0),
            "p95_latency_us": snap.get("request_latency_us_p95", 0.0),
            "p99_latency_us": snap.get("request_latency_us_p99", 0.0),
            "mean_latency_us": snap.get("request_latency_us_mean", 0.0),
            "queue_depth_mean": snap.get("queue_depth_mean", 0.0),
            "queue_depth_peak": int(snap.get("queue_depth_peak", 0)),
            "batch_fill_mean": snap.get("batch_fill_mean", 0.0),
            # ---- resilience ledger (counters from the same snapshot) ----
            "lane_faults": int(snap.get("lane_faults", 0)),
            "requeued": int(snap.get("requeued", 0)),
            "watchdog_timeouts": int(snap.get("watchdog_timeouts", 0)),
            "lane_restarts": int(snap.get("lane_restarts", 0)),
            "quarantines": int(snap.get("quarantines", 0)),
            "breaker_degraded": int(snap.get("breaker_degraded", 0)),
            "recoveries": int(snap.get("recoveries", 0)),
            "recovery_ms_mean": snap.get("recovery_ms_mean", 0.0),
            "integrity_checks": int(snap.get("integrity_checks", 0)),
            "integrity_failures": int(snap.get("integrity_failures", 0)),
            "canary_checks": int(snap.get("canary_checks", 0)),
            "canary_failures": int(snap.get("canary_failures", 0)),
            "trace_checks": int(snap.get("trace_checks", 0)),
            "trace_failures": int(snap.get("trace_failures", 0)),
            "ecc_detected": int(snap.get("ecc_detected", 0)),
            "lane_health": lane_health,
            # ---- telemetry tier ----
            "events_total": int(snap.get("events_total", 0)),
            "events_dropped": int(snap.get("events_dropped", 0)),
        }
        # program-cache residency for the process this scheduler runs in —
        # an ops view: growing evictions under steady traffic means the
        # byte budget is thrashing live programs
        cache_stats = get_cache().stats()
        st["program_cache_bytes"] = int(cache_stats["bytes"])
        st["program_cache_evictions"] = int(cache_stats["evictions"])
        # transport health for the same process — how this scheduler's
        # program arrived (and whether followers are retrying/failing to
        # fetch from here). Lazy import: schedulers in single-host launches
        # never pay for the transport module.
        from repro_torch.distributed.transport import metrics_snapshot
        tsnap = metrics_snapshot()
        st["transport_publishes"] = int(tsnap.get("publishes", 0))
        st["transport_serves"] = int(tsnap.get("serves", 0))
        st["transport_fetches"] = int(tsnap.get("fetches", 0))
        st["transport_fetch_bytes"] = int(tsnap.get("fetch_bytes", 0))
        st["transport_fetch_retries"] = int(tsnap.get("fetch_retries", 0))
        st["transport_fetch_failures"] = int(tsnap.get("fetch_failures", 0))
        st["transport_fetch_ms_p95"] = float(tsnap.get("fetch_ms_p95", 0.0))
        if self.family == "board":
            board_cycles = int(snap.get("board_cycles", 0))
            cost = getattr(self.lanes[0].runtime, "cost", None)
            clock = cost.clock_hz if cost is not None else 1.0
            st.update({
                "board_cycles": board_cycles,
                "board_stalls": int(snap.get("board_stalls", 0)),
                "board_cycles_per_image": per_image(board_cycles),
                "board_model_us_per_image":
                    per_image(1e6 * board_cycles / clock),
                "board_nj_per_image": per_image(snap.get("board_nj", 0.0)),
            })
        return st

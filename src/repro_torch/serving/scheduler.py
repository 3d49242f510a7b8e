"""Serving scheduler — the tier behind ``SNNServeEngine``, inline mode.

The port of ``repro.serving.scheduler`` for ``workers=0``: an admission
queue, greedy ``max_batch``-sized batches served on the calling thread by one
lane that owns a runtime built from a registry spec string, the overflow →
dense reroute, and per-request latency percentiles on top of the
accelerator/system scope split.

  * every batch is zero-padded to ``max_batch`` rows, so each lane serves
    one fixed shape whatever the traffic;
  * a lane is commissioned before it serves: a zero probe batch warms it
    (the first launch builds the CUDA kernels), then the artifact checksum
    (``faults.detect``) runs on its in-memory copy; a lane that fails either
    is refused with ``RuntimeError``;
  * a lane's runtime comes from ``spec`` and ``kernel``: an event-mode
    accelerator is fed packed frames, every other runtime (the reference,
    ``accelerator-batch`` with ``kernel="torch"`` or ``"cuda"``, the board)
    images;
  * a board lane adds the cost-model account of its real rows to the
    stats (PL cycles, stalls, dynamic energy); the board backpressures and
    never reroutes, so its ``overflow_fallbacks`` stay 0;
  * rows whose event frames exceed the artifact's E_max are served again
    through the dense ``accelerator-batch`` runtime on plain PyTorch (the
    FPGA would backpressure; the serving tier reroutes) and counted;
  * accelerator scope is the device work of a batch: the clock stops after
    ``torch.cuda.synchronize()`` on the program's device, never around an
    asynchronous launch alone. System scope is everything a request pays.

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: worker lanes (``workers >= 1``) and their batching deadline (a
non-default ``max_wait_us``: the inline lane serves what is queued at once),
fault plans (``faults=``), canary probes (``canary_pool=``) and the recovery
knobs (``resilience=``).

Bit-exactness holds regardless of batching: every runtime evaluates rows
independently and pad rows never influence real ones.
"""

from __future__ import annotations

import collections
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
from repro_torch.faults.detect import runtime_integrity_errors
from repro_torch.telemetry import trace as ttrace
from repro_torch.telemetry.metrics import (DEPTH_BUCKETS, LATENCY_BUCKETS_US,
                                           MetricsRegistry)

_LATER = "(ROADMAP: port queue, worker lanes and resilience)"
#: the JAX default batching deadline; only worker lanes read it
_MAX_WAIT_US = 2000.0


class ServingError(RuntimeError):
    """A request completed with ``.error`` set; carries the request."""

    def __init__(self, request: "ServeRequest"):
        super().__init__(f"request {request.rid} failed: {request.error}")
        self.request = request


@dataclasses.dataclass
class ServeRequest:
    """One admitted classification request, completed in place."""
    rid: int
    image: np.ndarray             # (N_in,) float32 in [0, 1]
    label: int | None = None      # filled at completion
    steps: int | None = None      # timesteps consumed (latency mode)
    fallback_dense: bool = False  # served via the dense reroute
    lane: int | None = None       # lane that served it
    t_submit: float = 0.0         # perf_counter at admission
    t_done: float = 0.0           # perf_counter at completion
    error: str | None = None      # set instead of label if serving failed
    _span: object = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def latency_us(self) -> float:
        return 1e6 * (self.t_done - self.t_submit)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Lane:
    """One lane: a runtime built from the spec plus the lane-local serve
    path (host encode and event packing, overflow reroute)."""

    def __init__(self, lane_id: int, program: LoweredProgram, spec: str,
                 kernel: str | None, latency_mode: bool):
        self.lane_id = lane_id
        self.program = program
        self.art = program.artifact
        self.device = program.device
        self.spec = spec
        self.family, _, _ = spec.partition("-")
        self.latency_mode = bool(latency_mode)
        kw = {"latency_mode": latency_mode}
        if kernel is not None:
            kw["kernel"] = kernel
        self.runtime = make_runtime(program, spec, device=self.device, **kw)
        self._dense = None               # built on the first overflow
        self.T = program.T
        self.x_min = program.x_min
        self.e_max = program.e_max
        self.health = "healthy"

    def serve(self, images: np.ndarray, k: int) -> dict:
        """Serve a zero-padded (max_batch, N_in) buffer whose first ``k``
        rows are real traffic; returns labels/steps/fallback plus the stat
        deltas for the scheduler to merge."""
        if self.family == "accelerator" and self.runtime.mode == "event":
            return self._serve_event(images, k)
        return self._serve_forward(images, k)

    def _serve_forward(self, images: np.ndarray, k: int) -> dict:
        """board / reference / dense-accelerator path: forward(images)."""
        t0 = time.perf_counter()
        out = self.runtime.forward(images)
        _sync(self.device)
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
        """Packed-event path with the overflow→dense reroute. Encoding and
        packing run on the host; the frames reach the device in one copy."""
        times = ttfs.encode_ttfs(torch.from_numpy(images), self.T,
                                 self.x_min).numpy()
        frames = pack_events_batched(times, self.T, self.e_max,
                                     device=self.device)
        overflow = frames.overflow              # host flags, no device read

        t0 = time.perf_counter()
        out = self.runtime.forward(frames=frames,
                                   latency_mode=self.latency_mode,
                                   check_overflow=False)
        _sync(self.device)
        accel_s = time.perf_counter() - t0
        labels = out.labels.cpu().numpy()
        steps = out.steps.cpu().numpy()

        bad = np.nonzero(overflow[:k])[0]
        if bad.size:
            # the whole fixed-shape buffer goes through the dense path, as in
            # the JAX scheduler; only the overflow rows are taken from it
            if self._dense is None:
                self._dense = make_runtime(self.program, "accelerator-batch",
                                           device=self.device)
            t0 = time.perf_counter()
            dense_out = self._dense.forward(images=images)
            _sync(self.device)
            accel_s += time.perf_counter() - t0
            labels[bad] = dense_out.labels.cpu().numpy()[bad]
            steps[bad] = dense_out.steps.cpu().numpy()[bad]
        return {"accel_s": accel_s, "labels": labels, "steps": steps,
                "fallback": overflow, "overflow_fallbacks": int(bad.size)}


class ServingScheduler:
    """Admission queue + greedy micro-batching on one inline lane.

    ``submit()`` is thread-safe and returns a request id; ``drain()`` serves
    everything queued on the calling thread and returns every completed
    request; ``stats()`` reports both measurement scopes, latency
    percentiles, queue depth and the lane's checks; ``reset_stats()`` zeroes
    them (e.g. after a warm-up pass)."""

    def __init__(self, artifact: Artifact | LoweredProgram, *,
                 spec: str = "accelerator-event",
                 workers: int = 0, max_batch: int = 64,
                 max_wait_us: float = _MAX_WAIT_US, kernel: str | None = None,
                 latency_mode: bool = False, faults=None, resilience=None,
                 canary_pool: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        if workers < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        if workers:
            raise NotImplementedError(f"workers={workers}: only the inline "
                                      f"mode (workers=0) is ported {_LATER}")
        if max_wait_us != _MAX_WAIT_US:
            raise NotImplementedError(f"max_wait_us={max_wait_us}: only "
                                      f"worker lanes wait for a batch to "
                                      f"fill, not ported yet {_LATER}")
        if faults is not None:
            raise NotImplementedError(f"faults= needs the fault models, not "
                                      f"ported yet {_LATER}")
        if canary_pool is not None:
            raise NotImplementedError(f"canary_pool= needs the canary "
                                      f"detector, not ported yet {_LATER}")
        if resilience is not None:
            raise NotImplementedError(f"resilience= tunes the recovery "
                                      f"machinery, not ported yet {_LATER}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.spec = spec
        self.family = spec.partition("-")[0]
        self.kernel = kernel
        self.max_batch = int(max_batch)
        self.workers = 0
        self.latency_mode = bool(latency_mode)
        self.program = lower(artifact, device=device)
        self.device = self.program.device
        self.art = self.program.artifact
        self.n_in = self.program.n_in

        self._lock = threading.Lock()
        self._admission: collections.deque[ServeRequest] = collections.deque()
        self._completed: dict[int, ServeRequest] = {}
        self._next_rid = 0
        self._stop = False
        self.metrics = MetricsRegistry()
        self._batch_seq = 0
        self.reset_stats()
        self.lanes = [self._commission(0)]

    # ---------------------------------------------------------------- client
    def submit(self, image: np.ndarray) -> int:
        image = np.asarray(image, np.float32)
        if image.shape != (self.n_in,):
            raise ValueError(f"image must have shape ({self.n_in},), got "
                             f"{image.shape}")
        with self._lock:
            if self._stop:
                raise RuntimeError("scheduler is closed")
            rid = self._next_rid
            self._next_rid += 1
            req = ServeRequest(rid, image, t_submit=time.perf_counter())
            rec = ttrace.get()
            if rec.enabled:
                req._span = rec.begin("request", "system",
                                      trace=f"req-{rid:08d}",
                                      attrs={"rid": rid})
            self._admission.append(req)
            self._sample_depth()
            return rid

    def drain(self) -> dict[int, ServeRequest]:
        """Serve everything queued; pop and return every completed request
        (errored requests are returned, not raised)."""
        while True:
            with self._lock:
                if not self._admission:
                    done, self._completed = self._completed, {}
                    return done
                batch = []
                while self._admission and len(batch) < self.max_batch:
                    batch.append(self._admission.popleft())
            self._serve_batch(self.lanes[0], batch)

    def close(self, drain: bool = False) -> None:
        """Stop admission. With ``drain=True`` the queued backlog is served
        first; otherwise its requests complete with ``error="scheduler
        closed"``. Either way no admitted request is dropped silently."""
        if drain and not self._stop:
            self.drain()
        with self._lock:
            self._stop = True
            now = time.perf_counter()
            while self._admission:
                r = self._admission.popleft()
                r.error = "scheduler closed"
                r.t_done = now
                self._complete_locked(r)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -------------------------------------------------------------- serving
    def _complete_locked(self, r: ServeRequest) -> None:
        """Caller holds the lock: publish a finished request and close its
        span (the one place a request span closes)."""
        if r._span is not None:
            rec = ttrace.get()
            attrs = ({"error": r.error} if r.error is not None else
                     {"label": r.label, "steps": r.steps,
                      "fallback": r.fallback_dense})
            rec.emit("complete", "system", trace=r._span.trace,
                     parent=r._span.sid, attrs=attrs, meta={"lane": r.lane})
            rec.end(r._span)
            r._span = None
        self._completed[r.rid] = r

    def _serve_batch(self, lane: _Lane, batch: list[ServeRequest]) -> None:
        t0 = time.perf_counter()
        k = len(batch)
        images = np.zeros((self.max_batch, self.n_in), np.float32)
        for j, r in enumerate(batch):
            images[j] = r.image          # zero-pad to the fixed shape
        rec = ttrace.get()
        try:
            if rec.enabled:
                with self._lock:
                    seq = self._batch_seq
                    self._batch_seq += 1
                with rec.span("batch", "system", trace=f"batch-{seq:06d}",
                              attrs={"k": k, "max_batch": self.max_batch},
                              meta={"lane": lane.lane_id,
                                    "rids": [r.rid for r in batch]}):
                    delta = lane.serve(images, k)
            else:
                delta = lane.serve(images, k)
        except Exception as e:
            # inline mode has no retry machinery: complete every request of
            # the batch with .error so nothing strands, then re-raise
            now = time.perf_counter()
            with self._lock:
                self.metrics.inc("lane_faults")
                self.metrics.inc("errors", k)
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
                    r.lane, r.t_done = lane.lane_id, now
                    self._complete_locked(r)
            raise
        now = time.perf_counter()
        with self._lock:
            m = self.metrics
            for j, r in enumerate(batch):
                r.label = int(delta["labels"][j])
                r.steps = int(delta["steps"][j])
                r.fallback_dense = bool(delta["fallback"][j])
                r.lane = lane.lane_id
                r.t_done = now
                self._complete_locked(r)
                m.observe("request_latency_us", r.latency_us,
                          LATENCY_BUCKETS_US)
            m.inc("images_out", k)
            m.inc("batches")
            m.observe("batch_fill", k, DEPTH_BUCKETS)
            m.inc("accel_s", delta["accel_s"])
            m.inc("system_s", now - t0)
            m.inc("overflow_fallbacks", delta["overflow_fallbacks"])
            m.inc("board_cycles", delta.get("board_cycles", 0))
            m.inc("board_nj", delta.get("board_nj", 0.0))
            m.inc("board_stalls", delta.get("board_stalls", 0))

    def _commission(self, lane_id: int) -> _Lane:
        """Build a lane, warm it with a zero probe batch, then run the
        artifact checksum on its in-memory copy."""
        lane = _Lane(lane_id, self.program, self.spec, self.kernel,
                     self.latency_mode)
        lane.serve(np.zeros((self.max_batch, self.n_in), np.float32), 0)
        errs = runtime_integrity_errors(lane.runtime)
        self.metrics.inc("integrity_checks")
        if errs:
            self.metrics.inc("integrity_failures")
            self.metrics.inc("lane_faults")
            lane.health = "quarantined"
            raise RuntimeError(f"lane {lane_id} failed its startup checks: "
                               + "; ".join(errs))
        return lane

    # ---------------------------------------------------------------- stats
    def _sample_depth(self) -> None:
        d = len(self._admission)
        self.metrics.observe("queue_depth", d, DEPTH_BUCKETS)
        self.metrics.set_max("queue_depth_peak", d)

    #: percentile window (a sliding window over the most recent requests)
    LATENCY_WINDOW = 65536

    def reset_stats(self) -> None:
        """Zero the registry in place (post-warm-up semantics)."""
        m = self.metrics
        m.reset()
        m.histogram("request_latency_us", LATENCY_BUCKETS_US,
                    window=self.LATENCY_WINDOW)
        m.histogram("batch_fill", DEPTH_BUCKETS)
        m.histogram("queue_depth", DEPTH_BUCKETS)

    def stats(self) -> dict:
        """One consistent ``metrics.snapshot()`` in the JAX scheduler's key
        names, minus the keys of what the port does not serve yet (worker
        recovery and canaries). The ``transport_*`` keys report this
        process's program transport (``distributed.transport.METRICS``):
        publishes, serves, fetches, fetched bytes, retries, failures and the
        p95 fetch time in ms. The board family adds its
        cost-model account over the served rows: ``board_cycles``,
        ``board_stalls``, ``board_cycles_per_image``,
        ``board_model_us_per_image`` (cycles at the board's clock: the
        modelled PL latency, not time on the card) and
        ``board_nj_per_image``."""
        with self._lock:
            snap = self.metrics.snapshot()
            lane_health = [lane.health for lane in self.lanes]
        n = int(snap.get("images_out", 0))

        def per_image(x):
            return x / n if n else 0.0
        accel_s = float(snap.get("accel_s", 0.0))
        system_s = float(snap.get("system_s", 0.0))
        cache_stats = get_cache().stats()
        st = {
            "spec": self.spec,
            "device": str(self.device),
            "workers": self.workers,
            "max_batch": self.max_batch,
            "accelerator_s": accel_s,
            "system_s": system_s,
            "host_overhead_s": max(0.0, system_s - accel_s),
            "images_out": n,
            "overflow_fallbacks": int(snap.get("overflow_fallbacks", 0)),
            "errors": int(snap.get("errors", 0)),
            "batches": int(snap.get("batches", 0)),
            "accel_us_per_image": per_image(1e6 * accel_s),
            "system_us_per_image": per_image(1e6 * system_s),
            "p50_latency_us": snap.get("request_latency_us_p50", 0.0),
            "p95_latency_us": snap.get("request_latency_us_p95", 0.0),
            "p99_latency_us": snap.get("request_latency_us_p99", 0.0),
            "mean_latency_us": snap.get("request_latency_us_mean", 0.0),
            "queue_depth_mean": snap.get("queue_depth_mean", 0.0),
            "queue_depth_peak": int(snap.get("queue_depth_peak", 0)),
            "batch_fill_mean": snap.get("batch_fill_mean", 0.0),
            "lane_faults": int(snap.get("lane_faults", 0)),
            "integrity_checks": int(snap.get("integrity_checks", 0)),
            "integrity_failures": int(snap.get("integrity_failures", 0)),
            "lane_health": lane_health,
            "events_total": int(snap.get("events_total", 0)),
            "events_dropped": int(snap.get("events_dropped", 0)),
            "program_cache_bytes": int(cache_stats["bytes"]),
            "program_cache_evictions": int(cache_stats["evictions"]),
        }
        # transport health for the same process — how this scheduler's
        # program arrived. Lazy import: schedulers in single-host launches
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

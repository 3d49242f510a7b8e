"""The differential oracle stack — every runtime, one fuzzed artifact.

The port of ``repro.conformance.oracles``. ``run_case`` takes a
``FuzzedCase`` and runs EVERY advertised runtime spec of the port's registry
on the same artifact and adversarial image batch, on one device, asserting:

  registry      — ``runtimes.registry_consistency_errors`` is empty: what the
                  registry advertises constructs, and what constructs is
                  advertised (both directions);
  lowering      — the single lowering stage is deterministic: two
                  cache-bypassing lowerings agree on the program fingerprint
                  and every scalar, the process cache returns the same
                  program, and every advertised runtime's ``.program``
                  carries that one fingerprint;
  program-io    — the serialized envelope reconstructs a program equal to a
                  fresh lowering on the same device (fingerprint, scalars,
                  plans, every tensor bit for bit, the same bytes when
                  serialized again), and a truncated envelope is refused;
  transport     — a seed-rotated window of four fault-proxy scenarios over
                  real loopback sockets: every fetch fails with a typed error
                  or reconstructs the leader's fingerprint;
  differential  — labels, first-spike times, final membranes AND step counts
                  are bit-exact against the software reference for every spec
                  (alias specs must construct an identical runtime config and
                  are credited without a redundant run);
  sched-batched — the per-image host board scheduler and the batched path
                  agree on outputs AND full cycle/energy traces, in both
                  full-T and latency mode;
  fifo          — the AER ingress never drops: per-tick queue counts sum to
                  the number of valid input spikes, and the batched trace
                  dispatched exactly that many events per image;
  cost-model    — the board trace equals an independent re-evaluation of the
                  board cost model via ``board.energy.account`` from the AER
                  queue's own counts (cycles, energy, synops, stalls);
  quant         — ``dequantize(quantize(w))`` honors the round-to-nearest
                  error bound scale/2 on the artifact's actual weights;
  events        — the packed frames respect the artifact's calibrated E_max
                  (no overflow flag on a stream the exporter sized for);
  fault-recovery — a scheduler whose single worker lane crashes on its first
                  batch (a seeded, recoverable lane fault) serves every
                  image with the reference label, and its ledger shows the
                  detection, the requeue and the rebuild;
  telemetry     — two seeded board runs produce bit-identical canonical span
                  trees, the per-image scheduler and the batched path
                  produce the SAME canonical tree, every span carries a
                  legal ``accel|system`` scope, and the span tree's cycle
                  totals reconcile with an independent re-evaluation of the
                  board cost model.

Every oracle of the JAX package runs: ``NOT_PORTED`` is empty. The report
keeps its ``not_ported`` field (an oracle named there would not run and
would not count as passed).

Each oracle yields an ``OracleOutcome``; a ``ConformanceReport`` aggregates
them and renders a failure summary naming spec, oracle, and mismatch counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.board import SNNBoard
from repro_torch.board.energy import account
from repro_torch.board.event_queue import AEREventQueue
from repro_torch.conformance.fuzz import FuzzedCase
from repro_torch.core import quant
from repro_torch.core.events import pack_events_batched
from repro_torch.core.lowering import REQUIRED_ARRAYS, lower, resolve_device
from repro_torch.core.runtimes import (ADVERTISED_SPECS, make_runtime,
                                       registry_consistency_errors)
from repro_torch.telemetry import trace as ttrace

#: the JAX package's oracles this port cannot run yet, and what each needs
NOT_PORTED: dict[str, str] = {}


@dataclasses.dataclass
class OracleOutcome:
    oracle: str
    spec: str
    passed: bool
    detail: str = ""
    stats: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ConformanceReport:
    seed: int
    notes: dict
    outcomes: list[OracleOutcome]
    #: oracle -> the module it waits for; these did not run
    not_ported: dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(NOT_PORTED))

    @property
    def passed(self) -> bool:
        """Every oracle that ran passed (``not_ported`` ones did not run)."""
        return all(o.passed for o in self.outcomes)

    def failures(self) -> list[OracleOutcome]:
        return [o for o in self.outcomes if not o.passed]

    def summary(self) -> str:
        fails = self.failures()
        head = (f"conformance case seed={self.seed} "
                f"(n_in={self.notes.get('n_in')} n_out={self.notes.get('n_out')} "
                f"T={self.notes.get('T')} leak={self.notes.get('leak_shift')} "
                f"weights={self.notes.get('weight_family')}): "
                f"{len(self.outcomes) - len(fails)}/{len(self.outcomes)} "
                f"oracles passed; not ported, not run: "
                f"{', '.join(sorted(self.not_ported)) or 'none'}")
        lines = [head] + [f"  FAIL [{o.oracle}] {o.spec}: {o.detail}"
                          for o in fails]
        return "\n".join(lines)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _runtime_key(rt) -> tuple:
    """Config identity of a constructed runtime: two specs mapping to the
    same key are aliases and must behave identically by construction."""
    return (type(rt).__name__, getattr(rt, "mode", None),
            getattr(rt, "kernel", None), getattr(rt, "latency_mode", None))


#: the keys of the batched board's full-T runtimes, whose trace the fifo and
#: cost-model oracles read
BOARD_BATCHED_KEYS = (("SNNBoardBatched", None, "torch", False),
                      ("SNNBoardBatched", None, "cuda", False))


def _diff_outputs(out, ref, fields=("labels", "first_spike", "v_final",
                                    "steps")) -> tuple[dict, str]:
    """Per-image mismatch counts between two SNNOutput-likes."""
    stats, parts = {}, []
    for f in fields:
        a, b = _np(getattr(out, f)), _np(getattr(ref, f))
        if a.shape != b.shape:
            # a wrong shape means every image is wrong — count it that way
            # so aggregated mismatch metrics cannot read as bit-exact
            stats[f] = int(b.shape[0]) if b.ndim else 1
            parts.append(f"{f} shape {a.shape} vs {b.shape}")
            continue
        per_img = (a != b) if a.ndim == 1 else np.any(
            a.reshape(a.shape[0], -1) != b.reshape(b.shape[0], -1), axis=1)
        n = int(np.sum(per_img))
        stats[f] = n
        if n:
            parts.append(f"{f} mismatches on {n} images")
    return stats, "; ".join(parts)


def run_case(case: FuzzedCase, specs=ADVERTISED_SPECS, py_slice: int = 5, *,
             device: str | torch.device = "cuda") -> ConformanceReport:
    """Run the ported oracle stack for one fuzzed case on ``device``.
    ``py_slice`` bounds the per-image host scheduler's batch (it is
    deliberately slow); the fuzzer orders the named adversarial patterns
    (flood/never/ties/ramp/burst) first, so the default slice covers all of
    them."""
    device = resolve_device(device)
    art, images, times = case.artifact, case.images, case.times
    T = int(art.m("encode", "T"))
    e_max = int(art.m("events", "e_max"))
    n_pad = int(art.m("codesign", "n_pad"))
    B = images.shape[0]
    py_slice = min(py_slice, B)
    outcomes: list[OracleOutcome] = []

    # ---- registry: advertised <-> constructible, both directions ---------
    errs = registry_consistency_errors(art, device=device)
    outcomes.append(OracleOutcome("registry", "*", not errs, "; ".join(errs)))

    # ---- lowering: deterministic, and every runtime consumes ONE program -
    outcomes.append(_lowering_oracle(art, specs, device))

    # ---- program-io: the serialized envelope reconstructs bit-identically
    outcomes.append(_program_io_oracle(art, device))

    # ---- transport: detected-or-bit-exact under packet-level faults ------
    outcomes.append(_transport_oracle(art, case.seed, device))

    # ---- differential: every advertised spec vs the reference ------------
    ref_rt = make_runtime(art, "reference", device=device)
    out_ref = ref_rt.forward(images)
    ran: dict[tuple, str] = {_runtime_key(ref_rt): "reference"}
    board_batched = None
    for spec in specs:
        if spec == "reference":
            continue
        rt = make_runtime(art, spec, device=device)
        key = _runtime_key(rt)
        if key in ran:
            outcomes.append(OracleOutcome(
                "differential", spec, True,
                f"alias of {ran[key]!r} (identical runtime config)"))
            continue
        ran[key] = spec
        if isinstance(rt, SNNBoard):   # per-image host scheduler: slice
            out = rt.forward(images[:py_slice])
            ref_cmp = type(out_ref)(*(f[:py_slice] for f in out_ref))
            n_img = py_slice
        else:
            out = rt.forward(images)
            ref_cmp = out_ref
            n_img = B
        stats, detail = _diff_outputs(out, ref_cmp)
        stats["img"] = n_img
        outcomes.append(OracleOutcome("differential", spec,
                                      not detail, detail, stats))
        if key in BOARD_BATCHED_KEYS and board_batched is None:
            board_batched = rt

    # ---- scheduler <-> batched: outputs AND traces, both modes -----------
    for latency in (False, True):
        mode = "latency" if latency else "full"
        py = make_runtime(art, "board-py", latency_mode=latency,
                          device=device)
        bt = make_runtime(art, "board", latency_mode=latency, device=device)
        out_py = py.forward(images[:py_slice])
        out_bt = bt.forward(images[:py_slice])
        stats, detail = _diff_outputs(out_bt, out_py)
        parts = [detail] if detail else []
        for f in dataclasses.fields(py.last_trace):
            a = _np(getattr(py.last_trace, f.name))
            b = _np(getattr(bt.last_trace, f.name))
            if not np.array_equal(a, b):
                parts.append(f"trace.{f.name} differs "
                             f"(py {a.tolist()} vs batched {b.tolist()})")
        outcomes.append(OracleOutcome(f"sched-batched-{mode}", "board",
                                      not parts, "; ".join(parts), stats))

    # ---- FIFO never-drops + cost-model consistency -----------------------
    totals = np.zeros(B, np.int64)
    stalls = np.zeros(B, np.int64)
    fifo_errs = []
    for b in range(B):
        q = AEREventQueue(times[b], T, e_max)
        per_tick = q.counts()
        valid = int(np.sum(times[b] < T))
        if int(per_tick.sum()) != valid or q.total_events != valid:
            fifo_errs.append(f"image {b}: queue schedules "
                             f"{int(per_tick.sum())}/{q.total_events} of "
                             f"{valid} valid events")
        totals[b] = valid
        stalls[b] = int(sum(q.stalls_at(t) for t in range(T)))
    if board_batched is None:
        # not among the requested specs: run it here; otherwise the
        # differential loop's full-batch forward already left last_trace
        board_batched = make_runtime(art, "board", device=device)
        board_batched.forward(images)
    tr = board_batched.last_trace
    if not np.array_equal(_np(tr.events), totals):
        fifo_errs.append(f"batched trace dispatched {_np(tr.events).tolist()} "
                         f"events but the AER schedule holds {totals.tolist()}"
                         " — events were dropped or double-counted")
    outcomes.append(OracleOutcome("fifo", "board", not fifo_errs,
                                  "; ".join(fifo_errs)))

    expected = account(totals, np.full(B, T, np.int64), stalls, n_pad,
                       board_batched.cost)
    cost_errs = []
    for f in dataclasses.fields(expected):
        a, b = _np(getattr(expected, f.name)), _np(getattr(tr, f.name))
        if not np.array_equal(a, b):
            cost_errs.append(f"{f.name}: expected {a.tolist()}, "
                             f"trace has {b.tolist()}")
    outcomes.append(OracleOutcome("cost-model", "board", not cost_errs,
                                  "; ".join(cost_errs)))

    # ---- quantization roundtrip bound ------------------------------------
    scale = float(art.m("quant", "scale"))
    w_f32, w_int8 = _np(art["w_float"]), _np(art["w_int8"])
    err = float(np.max(np.abs(quant.dequantize(w_int8, scale) - w_f32))) \
        if w_f32.size else 0.0
    bound = scale / 2 + 1e-6
    q_errs = []
    if not scale > 0:
        q_errs.append(f"non-positive scale {scale}")
    if err > bound:
        q_errs.append(f"roundtrip error {err:.3e} exceeds scale/2 bound "
                      f"{bound:.3e}")
    if int(np.max(np.abs(w_int8.astype(np.int32)))) > quant.INT8_MAX:
        q_errs.append("int8 weights exceed symmetric range")
    outcomes.append(OracleOutcome("quant", "*", not q_errs, "; ".join(q_errs),
                                  {"roundtrip_err": err, "bound": bound}))

    # ---- packed events respect the calibrated E_max ----------------------
    frames = pack_events_batched(times, T, e_max, device=device)
    n_over = int(np.sum(frames.overflow))
    peak = int(frames.count.max()) if T else 0
    outcomes.append(OracleOutcome(
        "events", "*", n_over == 0,
        f"{n_over} images overflow the calibrated E_max={e_max}" if n_over
        else "",
        {"e_max": e_max, "peak_count": peak,
         "boundary_hit": int(peak == e_max)}))

    # ---- fault recovery: serve through one seeded recoverable fault ------
    outcomes.append(_fault_recovery_oracle(case, out_ref, device))

    # ---- telemetry: deterministic spans that reconcile with the account --
    outcomes.append(_telemetry_oracle(case, py_slice, device))

    return ConformanceReport(seed=case.seed, notes=case.notes,
                             outcomes=outcomes)


def _lowering_oracle(art, specs, device) -> OracleOutcome:
    """Lowering conformance: the single lowering stage is deterministic and
    really is single. Two independent (cache-bypassing) lowerings of the
    same artifact must agree on the program fingerprint and every scalar;
    the cached path must return that same program; and every advertised
    runtime must carry a ``program`` whose fingerprint matches — i.e. no
    runtime lowered its own divergent view of the artifact."""
    errs: list[str] = []
    a = lower(art, device=device, cache=False)
    b = lower(art, device=device, cache=False)
    if a.fingerprint != b.fingerprint:
        errs.append(f"lowering is nondeterministic: {a.fingerprint[:12]} != "
                    f"{b.fingerprint[:12]}")
    scalars = ("T", "x_min", "e_max", "leak_shift", "n_in", "n_out",
               "n_groups", "per_group", "fallback", "scale", "n_pad", "lane")
    for f in scalars:
        if getattr(a, f) != getattr(b, f):
            errs.append(f"lowered scalar {f} differs across runs: "
                        f"{getattr(a, f)!r} vs {getattr(b, f)!r}")
    cached = lower(art, device=device)
    if cached.fingerprint != a.fingerprint:
        errs.append("cached lowering disagrees with a fresh lowering")
    for spec in specs:
        try:
            rt = make_runtime(art, spec, device=device)
        except Exception:  # noqa: BLE001 — the registry oracle's finding
            continue
        prog = getattr(rt, "program", None)
        if prog is None:
            errs.append(f"runtime {spec!r} exposes no lowered program")
        elif prog.fingerprint != a.fingerprint:
            errs.append(f"runtime {spec!r} lowered a divergent program "
                        f"({prog.fingerprint[:12]} != {a.fingerprint[:12]})")
    return OracleOutcome("lowering", "*", not errs, "; ".join(errs),
                         {"fingerprint": a.fingerprint[:16]})


def _program_io_oracle(art, device) -> OracleOutcome:
    """Program-io conformance: the broadcast envelope is a faithful carrier.
    A deserialized program must be indistinguishable from a fresh lower on
    the same device — same fingerprint, same scalars, same plans,
    bit-identical tensors of the same dtype and device — and a truncated
    envelope must be rejected, never half-applied."""
    from repro_torch.core.program_io import (SCALAR_FIELDS, ProgramIOError,
                                             deserialize_program,
                                             serialize_program)

    errs: list[str] = []
    fresh = lower(art, device=device, cache=False)
    blob = serialize_program(fresh)
    rt = deserialize_program(blob, art, device=device, cache=False)
    if rt.fingerprint != fresh.fingerprint:
        errs.append(f"roundtrip fingerprint {rt.fingerprint[:12]} != fresh "
                    f"lower's {fresh.fingerprint[:12]}")
    for f in SCALAR_FIELDS:
        if getattr(rt, f) != getattr(fresh, f):
            errs.append(f"roundtrip scalar {f}: {getattr(rt, f)!r} != "
                        f"{getattr(fresh, f)!r}")
    if rt.encode != fresh.encode or rt.decode != fresh.decode:
        errs.append("roundtrip encode/decode plans differ")
    for name in REQUIRED_ARRAYS:
        a, b = getattr(rt, name), getattr(fresh, name)
        if not (a.device == b.device and a.shape == b.shape
                and a.dtype == b.dtype and torch.equal(a, b)):
            errs.append(f"roundtrip tensor {name} is not bit-identical on "
                        f"{b.device}")
    # serialization is canonical: same program, same bytes
    if serialize_program(rt) != blob:
        errs.append("re-serializing the roundtripped program changed bytes")
    try:
        deserialize_program(blob[:-2], art, device=device, cache=False)
        errs.append("truncated envelope was accepted")
    except ProgramIOError:
        pass
    return OracleOutcome("program-io", "*", not errs, "; ".join(errs),
                         {"envelope_bytes": len(blob)})


def _transport_oracle(art, seed: int, device) -> OracleOutcome:
    """Transport conformance: *detected-or-bit-exact* under packet faults.

    Runs a seed-rotated window of the fault-proxy scenarios (real sockets,
    real fetcher, this case's real envelope) — every fetch must either fail
    with a typed error naming the corruption or reconstruct a program
    fingerprint-identical to the leader's. ``run_suite`` over every scenario
    is the full sweep; the per-case window here means the fuzzed-artifact
    population collectively covers every scenario while one case stays
    cheap."""
    from repro_torch.conformance.transport_faults import SCENARIOS, run_suite
    from repro_torch.core.program_io import serialize_program

    prog = lower(art, device=device)
    blob = serialize_program(prog)
    # stale-replay needs a second artifact's envelope; the full sweep has it
    pool = [sc for sc in SCENARIOS if sc.kind != "stale"]
    start = seed % len(pool)
    window = tuple(pool[(start + j) % len(pool)] for j in range(4))
    verdicts = run_suite(blob, art, prog.fingerprint, scenarios=window,
                         seed=seed, device=device)
    bad = [v for v in verdicts if not v["ok"]]
    detail = "; ".join(
        f"{v['scenario']}: expected {v['expect']}, got {v['outcome']} "
        f"({v['detail']})" for v in bad)
    return OracleOutcome(
        "transport", "*", not bad, detail,
        {"scenarios": len(verdicts),
         "detected": sum(v["outcome"] == "detected" for v in verdicts),
         "bitexact": sum(v["outcome"] == "bitexact" for v in verdicts)})


def _telemetry_oracle(case: FuzzedCase, py_slice: int,
                      device) -> OracleOutcome:
    """Telemetry conformance: spans are part of the measurement surface, so
    they get the same differential treatment as outputs — repeatable bit
    for bit, implementation-independent, scoped, and reconciled against the
    cost model they claim to project."""
    art, images, times = case.artifact, case.images, case.times
    T = int(art.m("encode", "T"))
    e_max = int(art.m("events", "e_max"))
    n_pad = int(art.m("codesign", "n_pad"))
    imgs = images[:py_slice]
    errs: list[str] = []

    def traced_run(spec: str) -> ttrace.Tracer:
        t = ttrace.Tracer()
        prev = ttrace.install(t)
        try:
            make_runtime(art, spec, device=device).forward(imgs)
        finally:
            ttrace.install(prev)
        return t

    # 1) repeatability: two seeded runs → bit-identical canonical trees
    t1 = traced_run("board")
    t2 = traced_run("board")
    if t1.fingerprint() != t2.fingerprint():
        errs.append("two identical seeded board runs produced different "
                    "canonical span trees (nondeterminism in a canonical "
                    "field — wall clocks/meta belong elsewhere)")

    # 2) implementation independence: the per-image host scheduler and the
    #    batched path must project the SAME canonical tree
    tp = traced_run("board-py")
    if t1.canonical() != tp.canonical():
        a, b = t1.canonical(), tp.canonical()
        bad = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   min(len(a), len(b)))
        errs.append(f"board-batched and board-py canonical span trees "
                    f"diverge at span {bad} "
                    f"({len(a)} vs {len(b)} spans)")

    # 3) every span carries a legal scope tag
    bad_scope = [s.name for s in t1.sorted_spans()
                 if s.scope not in ttrace.SCOPES]
    if bad_scope:
        errs.append(f"spans with illegal scope: {bad_scope[:4]}")

    # 4) logical clocks reconcile: per-image span cycles == an independent
    #    re-evaluation of the board cost model from the AER queue's counts
    cost = make_runtime(art, "board", device=device).cost
    valid = np.asarray([int(np.sum(times[b] < T)) for b in range(len(imgs))],
                       np.int64)
    stalls = np.zeros(len(imgs), np.int64)
    for b in range(len(imgs)):
        q = AEREventQueue(times[b], T, e_max)
        stalls[b] = int(sum(q.stalls_at(t) for t in range(T)))
    expect = account(valid, np.full(len(imgs), T, np.int64), stalls, n_pad,
                     cost)
    img_spans = sorted(t1.find("board.image"),
                       key=lambda s: s.attrs.get("i", -1))
    if len(img_spans) != len(imgs):
        errs.append(f"{len(img_spans)} board.image spans for "
                    f"{len(imgs)} images")
    else:
        span_cycles = np.asarray([s.attrs["cycles"] for s in img_spans],
                                 np.int64)
        if not np.array_equal(span_cycles, np.asarray(expect.cycles)):
            errs.append(f"span cycle accounts diverge from the independent "
                        f"cost-model evaluation (spans "
                        f"{span_cycles.tolist()}, model "
                        f"{np.asarray(expect.cycles).tolist()})")
        runs = t1.find("board.run")
        tot = int(np.sum(np.asarray(expect.cycles)))
        if len(runs) != 1 or int(runs[0].attrs.get("cycles", -1)) != tot:
            errs.append(f"board.run cycle total != sum of per-image "
                        f"accounts ({runs[0].attrs.get('cycles') if runs else None} "
                        f"vs {tot})")
    return OracleOutcome(
        "telemetry", "board", not errs, "; ".join(errs),
        {"spans": len(t1.sorted_spans()), "fingerprint_stable":
         int(t1.fingerprint() == t2.fingerprint())})


def _fault_recovery_oracle(case: FuzzedCase, out_ref,
                           device: torch.device) -> OracleOutcome:
    """Chaos conformance: serve the fuzzed images through a scheduler whose
    single lane crashes on its first batch (seeded, recoverable). The
    resilience tier must detect the fault, requeue the batch, scrub/rebuild
    the lane, and serve EVERY request with a label bit-exact to the
    reference — and the recovery ledger must show it happened."""
    from repro_torch.faults.plan import FaultPlan
    from repro_torch.serving.scheduler import ServingScheduler

    images = case.images
    B = images.shape[0]
    plan = FaultPlan(seed=case.seed, crash_batches=(0,))
    errs: list[str] = []
    st: dict = {}
    try:
        with ServingScheduler(case.artifact, spec="reference", workers=1,
                              max_batch=min(B, 8), max_wait_us=500.0,
                              faults=plan,
                              resilience={"backoff_s": 0.001},
                              device=device) as s:
            rids = [s.submit(img) for img in images]
            done = s.drain()
            st = s.stats()
        failed = [(r, done[r].error) for r in rids
                  if done[r].error is not None]
        if failed:
            errs.append(f"{len(failed)} requests errored after a recoverable "
                        f"fault (first: rid {failed[0][0]}: {failed[0][1]})")
        else:
            got = np.asarray([done[r].label for r in rids])
            want = _np(out_ref.labels)
            n_mm = int(np.sum(got != want))
            if n_mm:
                errs.append(f"post-recovery labels mismatch reference on "
                            f"{n_mm}/{B} images")
        if st.get("lane_faults", 0) < 1:
            errs.append("injected lane crash was never detected "
                        "(lane_faults == 0)")
        if st.get("requeued", 0) < 1:
            errs.append("crashed batch was not requeued (requeued == 0)")
        if st.get("lane_restarts", 0) < 1:
            errs.append("lane was never rebuilt (lane_restarts == 0)")
        if st.get("errors", 0):
            errs.append(f"{st['errors']} requests gave up despite a "
                        "one-shot recoverable fault")
        if st.get("images_out", 0) != B:
            errs.append(f"served {st.get('images_out', 0)}/{B} images")
    except Exception as e:  # noqa: BLE001 — a hang/crash IS the failure mode
        errs.append(f"serving through the fault raised "
                    f"{type(e).__name__}: {e}")
    return OracleOutcome(
        "fault-recovery", "serving", not errs, "; ".join(errs),
        {k: st.get(k, 0) for k in ("lane_faults", "requeued",
                                   "lane_restarts", "recoveries")})

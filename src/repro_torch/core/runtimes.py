"""Runtime registry — one place that maps a spec string to a runner.

The port of ``repro.core.runtimes``. Every runtime consumes the SAME
deployment artifact and exposes ``forward(images) -> SNNOutput``.

Spec grammar: ``family[-mode[-kernel]]``. The JAX package's kernel suffixes
map ``jnp`` -> ``torch`` and ``pallas`` -> ``cuda``; ``fused`` stays:

    reference                      software reference (the oracle)
    accelerator                    alias of accelerator-batch (family default)
    accelerator-batch[-torch|cuda] time-batched GEMM path
    accelerator-event[-torch|fused|cuda]
                                   packed-event path (kernel picked via the
                                   suffix or the ``kernel=`` keyword)
    board[-batched[-torch|cuda]]   board emulator, batched path (the kernel
                                   suffix selects the full-T LIF)
    board-py                       board emulator, per-image host scheduler
                                   (no kernel suffix)

``-cuda`` is the staged pipeline on the hand-written CUDA kernels
(``spike_matmul`` or ``event_accum``, then ``lif_fused`` and
``ttfs_decode``); on the board, ``lif_fused`` alone. ``ADVERTISED_SPECS``
lists every spec above, and ``registry_consistency_errors`` checks that each
constructs and that no other spelling of ``PROBE_OPTS`` does. The JAX
package's ``-pallas`` and ``-jnp`` spellings raise ``ValueError``.

Factories ignore keywords they don't understand, so harness-level defaults
(``kernel=``, ``latency_mode=``) can be passed uniformly across families.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.artifact import Artifact
from repro_torch.core.lowering import (LoweredProgram, get_cache, lower,
                                       lower_with_faults, resolve_device)
from repro_torch.telemetry import trace as ttrace

_REGISTRY: dict[str, Callable] = {}

#: every spec the module docstring advertises, fully expanded
ADVERTISED_SPECS = (
    "reference",
    "accelerator",
    "accelerator-batch", "accelerator-batch-torch", "accelerator-batch-cuda",
    "accelerator-event", "accelerator-event-torch", "accelerator-event-fused",
    "accelerator-event-cuda",
    "board", "board-batched", "board-batched-torch", "board-batched-cuda",
    "board-py",
)

def register(family: str):
    def deco(factory: Callable) -> Callable:
        _REGISTRY[family] = factory
        return factory
    return deco


def available() -> list[str]:
    return sorted(_REGISTRY)


def make_runtime(artifact: Artifact | LoweredProgram, spec: str, *,
                 device: str | torch.device = "cuda", faults=None, **kw):
    """Build the runtime named by ``spec`` over ``artifact`` (a raw
    ``Artifact`` or an already-lowered ``LoweredProgram``) on ``device``.

    ``faults`` accepts anything ``faults.plan.FaultPlan.coerce`` does
    (None | plan | spec string like ``"seu_weight=4,seed=7"`` | kwargs dict):

      * a STATIC plan (artifact-resident SEU bit flips) is a lowering pass
        (``lowering.lower_with_faults``): it corrupts an in-memory CLONE of
        the artifact for any runtime family — the caller's artifact stays
        pristine (it backs the scrub/reload recovery path) and the clone's
        unchanged SHA-256 manifest is the detector;
      * a DYNAMIC plan (membrane SEU, stuck groups, AER glitches, a forced
        FIFO depth) is only emulated by the per-image ``board-py``
        scheduler; every other spec rejects it with ``ValueError``;
      * lane-fault fields are the serving scheduler's concern and are
        ignored here.

    When a ``Tracer`` is installed, the ``runtime.build`` span's META gains
    ``cache_hit``, ``cache_bytes`` and ``cache_evictions``."""
    family, _, opts = spec.partition("-")
    if family not in _REGISTRY:
        raise ValueError(f"unknown runtime family {family!r} in spec "
                         f"{spec!r}; available: {available()}")
    if faults is not None:
        from repro_torch.faults.plan import DYNAMIC_FIELDS, FaultPlan
        plan = FaultPlan.coerce(faults)
        if plan.has_static:
            artifact = lower_with_faults(artifact, plan, device=device)
        if plan.has_dynamic:
            if family != "board" or opts.partition("-")[0] != "py":
                raise ValueError(
                    f"dynamic fault plans (fields {DYNAMIC_FIELDS}) are only "
                    f"emulated by the 'board-py' runtime; spec {spec!r} "
                    f"cannot inject {plan.describe()}")
            kw["faults"] = plan
    if isinstance(artifact, LoweredProgram):
        program = lower(artifact, device=device)
        program_hit = True
    else:
        program, program_hit = get_cache().program(artifact,
                                                   resolve_device(device))
    rec = ttrace.get()
    if not rec.enabled:
        return _REGISTRY[family](program, opts, **kw)
    with rec.span("runtime.build", "system", attrs={"family": family},
                  meta={"spec": spec}) as sp:
        rt = _REGISTRY[family](program, opts, **kw)
        if sp is not None:
            sp.meta["cache_hit"] = bool(getattr(rt, "cache_hit",
                                                program_hit))
            cs = get_cache().stats()
            sp.meta["cache_bytes"] = cs["bytes"]
            sp.meta["cache_evictions"] = cs["evictions"]
        return rt


#: near-miss grammar probe set: every way the spec grammar can be (mis)spelled
#: within the known families, modes and kernels, the JAX package's kernel
#: names included. ``registry_consistency_errors`` walks it: a spec either
#: constructs AND is advertised, or raises AND is not.
PROBE_OPTS = {
    "reference": ("", "torch", "bogus"),
    "accelerator": ("", "batch", "event",
                    "batch-torch", "batch-cuda", "batch-fused", "batch-jnp",
                    "batch-pallas", "batch-bogus",
                    "event-torch", "event-cuda", "event-fused", "event-jnp",
                    "event-pallas", "event-bogus",
                    "torch", "cuda", "fused", "jnp", "pallas", "bogus"),
    "board": ("", "batched", "py",
              "batched-torch", "batched-cuda", "batched-fused", "batched-jnp",
              "batched-pallas", "batched-bogus", "py-torch", "py-cuda",
              "torch", "cuda", "fused", "jnp", "pallas", "bogus"),
}


def probe_specs() -> list[str]:
    return [family + ("-" + opts if opts else "")
            for family, all_opts in PROBE_OPTS.items() for opts in all_opts]


def registry_consistency_errors(artifact: Artifact | LoweredProgram, *,
                                device: str | torch.device = "cuda"
                                ) -> list[str]:
    """The registry's advertise/construct contract, checked both ways on
    ``device``:

      1. the families ``available()`` exposes are exactly the families
         ``ADVERTISED_SPECS`` spells out;
      2. every advertised spec constructs against ``artifact``;
      3. no probe-set spec constructs WITHOUT being advertised.

    Returns a list of human-readable errors; empty means consistent."""
    errors: list[str] = []
    adv_families = {s.partition("-")[0] for s in ADVERTISED_SPECS}
    for fam in sorted(adv_families - set(available())):
        errors.append(f"family {fam!r} is advertised but not registered")
    for fam in sorted(set(available()) - adv_families):
        errors.append(f"family {fam!r} is registered but advertises no spec")
    for spec in ADVERTISED_SPECS:
        try:
            make_runtime(artifact, spec, device=device)
        except Exception as e:  # noqa: BLE001 — any failure is the finding
            errors.append(f"advertised spec {spec!r} does not construct: {e}")
    for spec in probe_specs():
        if spec in ADVERTISED_SPECS:
            continue  # construction already asserted above
        try:
            make_runtime(artifact, spec, device=device)
        except Exception:  # noqa: BLE001 — rejected and unadvertised
            continue
        errors.append(f"spec {spec!r} constructs but is not advertised")
    return errors


@register("reference")
def _reference(prog: LoweredProgram, opts: str, **_):
    from repro_torch.core.reference import SNNReference
    if opts:
        raise ValueError(f"reference runtime takes no options, got {opts!r}")
    return SNNReference(prog, device=prog.device)


@register("accelerator")
def _accelerator(prog: LoweredProgram, opts: str, kernel: str = "torch", **_):
    from repro_torch.core.accelerator import SNNAccelerator
    mode, _, k = opts.partition("-")
    return SNNAccelerator(prog, mode=mode or "batch", kernel=k or kernel,
                          device=prog.device)


@register("board")
def _board(prog: LoweredProgram, opts: str, latency_mode: bool = False,
           kernel: str = "torch", faults=None, **_):
    from repro_torch.board import SNNBoard, SNNBoardBatched
    mode, _, k = opts.partition("-")
    if mode in ("", "batched"):
        # forwarded, not swallowed: the batched path takes torch/cuda and
        # rejects every other kernel (the accelerator-only "fused" too)
        return SNNBoardBatched(prog, latency_mode=latency_mode,
                               kernel=k or kernel, device=prog.device)
    if mode == "py":
        if k:
            raise ValueError(f"board-py takes no kernel suffix, got {k!r} "
                             "(the per-image scheduler is host numpy)")
        # the host tick loop — the only family that emulates dynamic faults
        return SNNBoard(prog, latency_mode=latency_mode, faults=faults,
                        device=prog.device)
    raise ValueError(f"unknown board option {mode!r} "
                     "(use '', 'batched', 'py')")

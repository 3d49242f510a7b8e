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

``-cuda`` is the staged pipeline on the hand-written CUDA kernels
(``spike_matmul`` or ``event_accum``, then ``lif_fused`` and
``ttfs_decode``). ``ADVERTISED_SPECS`` lists every spec above; each
constructs. The ``-pallas`` spelling raises ``ValueError`` naming ``cuda``;
the ``board`` family raises ``NotImplementedError`` naming the ROADMAP item
that brings it.

Factories ignore keywords they don't understand, so harness-level defaults
(``kernel=``, ``latency_mode=``) can be passed uniformly across families.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.artifact import Artifact
from repro_torch.core.lowering import (LoweredProgram, get_cache, lower,
                                       resolve_device)
from repro_torch.telemetry import trace as ttrace

_REGISTRY: dict[str, Callable] = {}

#: every spec the module docstring advertises, fully expanded
ADVERTISED_SPECS = (
    "reference",
    "accelerator",
    "accelerator-batch", "accelerator-batch-torch", "accelerator-batch-cuda",
    "accelerator-event", "accelerator-event-torch", "accelerator-event-fused",
    "accelerator-event-cuda",
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

    When a ``Tracer`` is installed, the ``runtime.build`` span's META gains
    ``cache_hit``, ``cache_bytes`` and ``cache_evictions``."""
    family, _, opts = spec.partition("-")
    if family == "board":
        raise NotImplementedError(
            f"spec {spec!r}: the board emulator family is not ported yet "
            "(ROADMAP: port queue, the board family with kernel 5)")
    if family not in _REGISTRY:
        raise ValueError(f"unknown runtime family {family!r} in spec "
                         f"{spec!r}; available: {available()}")
    if faults is not None:
        raise NotImplementedError(
            "fault plans need faults/plan.py and faults/models.py, not "
            "ported yet (ROADMAP: port queue, resilience and fault injection)")
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

"""Deterministic fault injection + detection for the SNN deployment stack.

The port of ``repro.faults``, with the JAX package's twelve names:

``plan``   — seeded, immutable ``FaultPlan`` recipes (what goes wrong);
``models`` — the injectors interpreting a plan at the artifact / board /
             lane sites (how it goes wrong);
``detect`` — checksum, canary, trace, and ECC detectors (how it's caught).
"""

from repro_torch.faults.detect import (Canary, ecc_errors, integrity_errors,
                                       runtime_integrity_errors, trace_errors)
from repro_torch.faults.models import (FaultyAEREventQueue, InjectedFault,
                                       LaneFaultInjector,
                                       MembraneUpsetInjector, apply_stuck,
                                       corrupt_artifact)
from repro_torch.faults.plan import FaultPlan

__all__ = [
    "FaultPlan", "InjectedFault", "corrupt_artifact", "FaultyAEREventQueue",
    "MembraneUpsetInjector", "apply_stuck", "LaneFaultInjector", "Canary",
    "integrity_errors", "runtime_integrity_errors", "trace_errors",
    "ecc_errors",
]

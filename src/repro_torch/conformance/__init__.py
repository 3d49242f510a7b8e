"""Cross-runtime differential conformance suite — the port of
``repro.conformance``.

The paper's central claim is semantics preservation: ONE exported artifact,
and every runtime that consumes it produces bit-exact labels and first-spike
times. This package generalizes the claim to *any valid artifact*:

  * ``fuzz``    — random valid deployment artifacts plus adversarial event
    streams (floods, never-spike rows, exact-E_max boundaries, tie-heavy
    spike times), equal seed for seed to the JAX package's;
  * ``oracles`` — every advertised runtime spec of the port on the same
    fuzzed artifact, through the JAX package's whole oracle stack (the
    fault-recovery oracle included);
  * ``golden``  — pinned-seed golden traces, checked against
    ``tests/golden/``;
  * ``transport_faults`` — a fault-injecting TCP proxy (truncations, flipped
    bytes, re-framed tampering, stale replays, resets, stalls, slow-loris)
    behind the ``transport`` oracle's *detected-or-bit-exact* invariant:
    a fetched program either fails loudly naming the corruption or is
    fingerprint-identical to the leader's.
"""

from repro_torch.conformance.fuzz import FuzzedCase, fuzz_case, images_from_times
from repro_torch.conformance.oracles import (ConformanceReport, OracleOutcome,
                                             run_case)
from repro_torch.conformance.transport_faults import (SCENARIOS, FaultyProxy,
                                                      Scenario, run_scenario,
                                                      run_suite)
from repro_torch.conformance import golden

__all__ = ["FuzzedCase", "fuzz_case", "images_from_times",
           "ConformanceReport", "OracleOutcome", "run_case", "golden",
           "SCENARIOS", "FaultyProxy", "Scenario", "run_scenario",
           "run_suite"]

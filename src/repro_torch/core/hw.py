"""Hardware records: the paper's FPGA (its deployed design point and the
board cost model the serving stack binds to every lowered program) and the
card the port runs on, an NVIDIA H100 SXM5, whose rates the roofline reads
(``distributed/roofline.py``).

The board-side records are a copy of those of ``repro.core.hw``. The TPU
target record stays out of the port: no TPU number is a property of this
package, and no energy figure is kept for the card (NVIDIA publishes no
pJ per byte or per FLOP that this package could cite).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FpgaReference:
    """The paper's deployed design point (PYNQ-Z2 / XC7Z020) — for scope-aware
    comparisons in the benchmark harness."""

    name: str = "pynq-z2-80mhz"
    clock_hz: float = 80e6
    first_spike_cycles: int = 12
    service_cycles: int = 11
    service_latency_us: float = 0.1375
    dynamic_energy_nj: float = 31.6
    accuracy_pct: float = 87.40
    neurons_direct: int = 2048            # 16 groups x 128
    groups: int = 16
    neurons_per_group: int = 128
    encodable_neurons: int = 4890
    packed_synapses: int = 843_776
    bram_tiles: int = 140                 # saturated — the design is BRAM-limited


@dataclasses.dataclass(frozen=True)
class BoardCostModel:
    """Cycle/energy model of the PL event datapath driven by the board-runtime
    emulator (``repro_torch.board``). One constant per
    microarchitectural assumption, so the Table-3 analogue is auditable term
    by term:

      * AER dispatch is pipelined at II=1: each popped event costs
        ``cycles_per_event`` and its int8 weight row is accumulated into all
        ``groups`` hardware groups in parallel (the row spans every lane).
      * The tick boundary (leak shift + integrate + threshold compare +
        first-spike latch) updates every neuron in parallel:
        ``cycles_per_tick`` per tick regardless of network width.
      * The input FIFO has finite depth (the artifact's calibrated E_max);
        events beyond the depth in one tick are never dropped — the ingress
        backpressures, costing ``cycles_per_stall`` per excess event. This is
        the hardware's overflow policy (the serving tier reroutes instead).
      * ``cycles_fixed + cycles_decode`` is the zero-event service floor,
        calibrated to the paper's 11-cycle service latency (0.1375 us at
        80 MHz); the grouped TTFS comparator tree costs ``cycles_decode``.
      * Energy terms are per-op dynamic-energy estimates in pJ, order of
        magnitude only (the paper's 31.6 nJ/image is itself a Vivado UG907
        tool estimate): one synop is one
        int8 row-element accumulate into an int32 membrane; one neuron-tick
        is one leak-shift + compare; one event is one FIFO push+pop+route.
    """

    name: str = "pynq-z2-pl-model"
    clock_hz: float = 80e6                # PL clock (paper's design point)
    groups: int = 16                      # hardware neuron groups
    lane: int = 128                       # neurons per group
    cycles_per_event: int = 1             # AER pop + row fetch + accumulate
    cycles_per_tick: int = 1              # leak/integrate/fire, all lanes
    cycles_per_stall: int = 1             # FIFO backpressure per excess event
    cycles_fixed: int = 8                 # pipeline fill (ingress + row fetch)
    cycles_decode: int = 3                # grouped TTFS comparator tree
    pj_per_synop: float = 2.0
    pj_per_event: float = 10.0            # FIFO push+pop + router
    pj_per_neuron_tick: float = 1.0
    pj_per_decode: float = 500.0

    @property
    def neurons_direct(self) -> int:
        return self.groups * self.lane


@dataclasses.dataclass(frozen=True)
class GpuTarget:
    """One NVIDIA H100 SXM5 card, the rates of NVIDIA's H100 Tensor Core GPU
    datasheet (SXM5 column). The roofline's three terms read
    ``peak_bf16_flops``, ``hbm_bandwidth`` and ``link_bandwidth``."""

    name: str = "h100-sxm5"
    # BF16 Tensor Core, dense: the datasheet's 1,979 TFLOPS is with sparsity
    peak_bf16_flops: float = 989e12       # FLOP/s per card
    hbm_bandwidth: float = 3.35e12        # HBM3, bytes/s per card
    hbm_bytes: int = 80 * 2**30           # 80 GB of HBM3 per card
    # NVLink 4: 900 GB/s per card, both directions together; a collective's
    # bytes leave a card in one direction
    link_bandwidth: float = 450e9         # bytes/s per card, one direction


H100 = GpuTarget()
PYNQ_Z2 = FpgaReference()
PYNQ_COST = BoardCostModel()

"""Three-term roofline: the port of ``repro.distributed.roofline``, read on
the card's rates (``core.hw.H100``) instead of a TPU's:

    compute term    = FLOPs_per_chip      / peak_bf16_FLOPs        [s]
    memory term     = HBM_bytes_per_chip  / HBM_bandwidth          [s]
    collective term = wire_bytes_per_chip / link_bandwidth         [s]

Sources:
  * FLOPs / HBM bytes: the analytic model (``distributed/analytic.py``).
  * Collective bytes: JAX parses them out of the compiled program's HLO
    text (``repro.distributed.hloparse``), which torch does not produce.
    Here the caller hands them in by kind (``coll_by_kind``: per-card
    result bytes of "all-reduce", "all-gather", ...), read off the torch
    program by a communication count; on one card there are none and the
    term is zero. The wire model is JAX's: all-reduce 2x (reduce-scatter
    + all-gather), the rest 1x.

MODEL_FLOPS (the "useful compute" yardstick):
    train:   6 * N_active * tokens;  prefill: 2 * N_active * tokens;
    decode:  2 * N_active * batch.
The ratio MODEL_FLOPS / total FLOPs exposes remat recompute, attention
overhead and dispatch waste. ``step_s``, the largest term, is the least time
a step can take on these rates: a measured wall below it means the record
or the count is wrong.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hw import H100
from repro_torch.distributed import analytic as AN


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes: float            # per chip (wire model)
    coll_by_kind: dict
    model_flops: float           # global useful FLOPs
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_ratio: float
    step_s: float                # max of the three terms (overlap-optimistic)
    mfu: float                   # model_flops / (chips * peak * step_s)
    raw_hlo_flops: float = 0.0   # a compiler's own count, where one is given
    raw_hlo_bytes: float = 0.0

    def row(self) -> str:
        return (f"{self.arch:<22} {self.shape:<12} {self.mesh:<7} "
                f"c={self.compute_s:9.3e} m={self.memory_s:9.3e} "
                f"n={self.collective_s:9.3e} -> {self.bottleneck:<10} "
                f"useful={self.useful_ratio:6.1%} MFU={self.mfu:6.2%}")


def model_flops(cfg, cell) -> float:
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * (cfg.dec_max_len if cfg.family == "audio"
                                      else cell.seq_len)
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * (cfg.dec_max_len if cfg.family == "audio"
                                      else cell.seq_len)
        return 2.0 * n_active * tokens
    return 2.0 * n_active * cell.global_batch      # decode: one token per row


def wire_bytes(coll: dict[str, float]) -> float:
    """Bytes on the wire per card: an all-reduce's twice, the rest once."""
    return sum(2.0 * v if k == "all-reduce" else v for k, v in coll.items())


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int, cfg, cell,
            coll_by_kind: dict | None = None, cost: dict | None = None,
            hw=H100, **_) -> Roofline:
    """The roofline of ``cfg`` at ``cell`` over ``chips`` cards of ``hw``
    (any record with ``peak_bf16_flops``, ``hbm_bandwidth`` and
    ``link_bandwidth``), with ``coll_by_kind`` the per-card collective
    bytes by kind (none on one card) and ``cost`` a compiler's own
    ``flops`` / ``bytes accessed``, kept as ``raw_*``."""
    cost = cost or {}
    est = AN.estimate(cfg, cell, chips)
    coll = {k: float(v) for k, v in (coll_by_kind or {}).items()}
    cw = wire_bytes(coll)
    c_s = est["flops_per_chip"] / hw.peak_bf16_flops
    m_s = est["bytes_per_chip"] / hw.hbm_bandwidth
    n_s = cw / hw.link_bandwidth
    terms = {"compute": c_s, "memory": m_s, "collective": n_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, cell)
    useful = mf / est["flops_global"] if est["flops_global"] else 0.0
    step = max(terms.values())
    mfu = mf / (chips * hw.peak_bf16_flops * step) if step > 0 else 0.0
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    flops_per_chip=est["flops_per_chip"],
                    bytes_per_chip=est["bytes_per_chip"],
                    coll_bytes=cw, coll_by_kind=coll, model_flops=mf,
                    compute_s=c_s, memory_s=m_s, collective_s=n_s,
                    bottleneck=bottleneck, useful_ratio=useful,
                    step_s=step, mfu=mfu,
                    raw_hlo_flops=float(cost.get("flops", 0.0)),
                    raw_hlo_bytes=float(cost.get("bytes accessed", 0.0)))

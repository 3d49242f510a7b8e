"""Operations, bytes and peaks: the yardstick of the roofline and utilisation
metrics, worked out from a configuration file's published keys.

Copied, not imported, so that a change to the program cannot move it:

* the peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
  700 W limit): ``chip_smoke.py:536-541`` and ``src/repro_torch/core/hw.py``
  (``H100``: 989 TFLOP/s bf16, 3.35 TB/s HBM);
* attention's bytes and operations, ``attn_work`` of ``chip_smoke.py:5436``
  (phase 7): q, k, v read once and the output written once; 2 FLOPs a
  multiply-add in QK^T and in PV over the visible pairs; the kernel's bound
  is max(bytes / HBM, operations / peak) (``chip_smoke.py:5474``);
* model FLOPs, ``src/repro_torch/distributed/roofline.py:63``
  (``model_flops``: prefill 2 N_active tokens),
  with N counting the parameters that enter a product (the embedding is a
  lookup, as ``distributed/analytic.py:96`` leaves it out) and attention's
  own operations over the visible pairs added, so that a long context is
  not counted as free.
"""

from __future__ import annotations

from perfbench.weights import dims

BF16_FLOPS = 989e12          # FLOP/s, tensor cores, dense
HBM_BYTES_PER_S = 3.35e12    # bytes/s


def matmul_params(cfg: dict) -> int:
    """Parameters a token's products read: attention's four projections,
    the FFN (k of E experts, and the router) in every layer, and the
    head."""
    m = dims(cfg)
    d, dh = m["d"], m["dh"]
    attn = d * (m["hq"] + 2 * m["hkv"]) * dh + m["hq"] * dh * d
    ffn = 3 * d * m["f"] * (m["k"] if m["E"] else 1) + d * m["E"]
    return m["L"] * (attn + ffn) + d * m["V"]


def visible_pairs(S: int, window: int | None) -> int:
    """(query, key) pairs a causal attention over S positions computes,
    each query seeing at most ``window`` keys."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attn_work(B: int, Hq: int, Hkv: int, S: int, D: int,
              window: int | None, elsize: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one causal attention launch over (B, S)."""
    return (elsize * B * D * (2 * Hq * S + 2 * Hkv * S),
            4 * B * Hq * visible_pairs(S, window) * D)


def attn_bound_s(cfg: dict, B: int, S: int) -> float:
    """The least time one attention launch of the configuration could take
    on the card."""
    m = dims(cfg)
    n_bytes, n_ops = attn_work(B, m["hq"], m["hkv"], S, m["dh"],
                               cfg.get("sliding_window"))
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS)


def prefill_flops(cfg: dict, B: int, S: int) -> int:
    """Model FLOPs of one prefill of B rows of S tokens."""
    m = dims(cfg)
    attn = 4 * B * m["hq"] * visible_pairs(S, cfg.get("sliding_window")) \
        * m["dh"]
    return 2 * matmul_params(cfg) * B * S + m["L"] * attn


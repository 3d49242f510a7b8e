"""Integer quantization for deterministic deployment.

The port of ``repro.core.quant``, on the host in numpy as there: weights are
symmetric-per-tensor int8, membrane accumulation is int32, thresholds are
int32, leak is a power-of-two right shift. Every runtime shares these exact
integer semantics, which is what lets reference <-> accelerator agreement be
*bit-exact*, not allclose.
"""

from __future__ import annotations

import numpy as np

INT8_MAX = 127
INT32_NEVER_FIRE = np.int32(2**31 - 1)  # threshold for padded lanes


def quantize_weights(w: np.ndarray, *, bits: int = 8) -> tuple[np.ndarray, float]:
    """Symmetric per-tensor quantization. Returns (w_int8, scale) with
    w_float ~= w_int8 * scale."""
    qmax = 2 ** (bits - 1) - 1
    amax = float(np.max(np.abs(w)))
    if amax == 0.0:
        return np.zeros_like(w, dtype=np.int8), 1.0
    scale = amax / qmax
    w_q = np.clip(np.round(w / scale), -qmax, qmax).astype(np.int8)
    return w_q, scale


def dequantize(w_q: np.ndarray, scale: float) -> np.ndarray:
    return w_q.astype(np.float32) * scale


def leak_shift_from_tau(tau_steps: float) -> int:
    """Map a float leak time-constant (in steps) to the nearest power-of-two
    shift: v <- v - (v >> s) realizes decay factor (1 - 2**-s) per step.

    Edge cases (all deterministic, covered by tests):
      * tau <= 0 or tau == inf — the "leak disabled" sentinels; returns 31.
        ``v >> 31`` is 0 for v >= 0 but -1 for v < 0 (an arithmetic shift),
        so a negative membrane still gains 1 per step: the runtimes keep that
        behaviour, bit-exact with the JAX package.
      * NaN — rejected loudly; a NaN tau is a training bug, and silently
        picking a shift would bake it into the deployed artifact.
      * very large finite tau — decay -> 1; saturates at the largest
        representable shift (15), the weakest realizable leak.
    """
    if np.isnan(tau_steps):
        raise ValueError("tau_steps is NaN — refusing to pick a leak shift")
    if tau_steps <= 0 or np.isinf(tau_steps):
        return 31
    decay = np.exp(-1.0 / tau_steps)
    # choose s minimizing |(1 - 2^-s) - decay|
    candidates = np.arange(1, 16)
    return int(candidates[np.argmin(np.abs((1 - 2.0 ** -candidates) - decay))])

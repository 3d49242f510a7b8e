"""prefill_glue_share (%): device time of the kernels that are neither a
matrix product, a flash-attention kernel nor under the ``moe_ffn`` range
(norms, RoPE, SiLU, casts, embedding), over all device time of the traced
calls."""

from perfbench.trace import GLUE


def read(ctx):
    t = ctx.trace
    if t is None or not t["device_s"]:
        return None
    return 100.0 * t["groups"].get(GLUE, 0.0) / t["device_s"]

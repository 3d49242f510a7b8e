"""moe_ffn_ms_per_step (ms): device time of the kernels launched under the
``moe_ffn`` range the harness opens around ``models/moe.py::moe_ffn``, per
traced prefill call."""


def read(ctx):
    t, w = ctx.trace, ctx.window
    if t is None or "traced_calls" not in w:
        return None
    s = sum(v for (g, r), v in t["ranged"].items() if r == "moe_ffn")
    return 1e3 * s / w["traced_calls"] if s else None

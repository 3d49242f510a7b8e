"""moe_glue_share (%): the share of the ``moe_ffn`` range's device time
that is not a matrix product (routing, sort, cumsum, scatter, gather,
combine)."""

from perfbench.trace import MOE_GLUE


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = sum(v for (g, r), v in t["ranged"].items() if r == "moe_ffn")
    return 100.0 * t["ranged"].get((MOE_GLUE, "moe_ffn"), 0.0) / s \
        if s else None

"""flash_fwd_roofline (%): the least time one launch of kernel 8a
(``flash_sm90_kernel``) could take at the cell's shape
(``counts.attn_bound_s``: max(bytes once / HBM, operations / bf16 peak))
over its mean traced time per launch."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    names = [n for n in t["launches"] if "flash_sm90_kernel" in n]
    n = sum(t["launches"][k] for k in names)
    if not n:
        return None
    mean = sum(t["kernels"][k] for k in names) / n
    bound = ctx.counts.attn_bound_s(ctx.config, ctx.traffic["batch"],
                                    ctx.traffic["seq"])
    return 100.0 * bound / mean

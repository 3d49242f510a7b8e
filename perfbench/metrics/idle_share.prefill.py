"""idle_share.prefill (%): 1 less the union of the device's operations over
the traced prefill calls, as a share of their wall time."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

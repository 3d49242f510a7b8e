"""moe_slot_fill (%): the expert assignments the capacity rule kept over the
expert-buffer rows computed (E * B * C), summed over the MoE layers of the
traced calls: the program's ``moe_ffn.kept`` and ``moe_ffn.slots`` counts
(``repro_torch.telemetry.trace.device_counts``, taken while the profiler
runs). At capacity factor 1.0, E * C = S * k, so it reads 1 less the share
of assignments dropped; a program that takes no such count reads
nothing."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["device_s"]:
        return None
    try:
        from repro_torch.telemetry.trace import device_counts
    except ImportError:
        return None
    c = device_counts()
    slots = c.get("moe_ffn.slots")
    return 100.0 * c["moe_ffn.kept"] / slots if slots else None

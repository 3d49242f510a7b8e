"""The traced stretch: ``torch.profiler`` over a fixed amount of a cell's
traffic, run after the measured window, reduced to what the per-layer
readers and the ``breakdown`` need.

Frozen copies from ``chip_smoke.py``, so that the program cannot move the
yardstick: ``is_gemm`` (line 901), ``is_flash_forward`` (906),
``family_group`` (929), ``ranged`` (946), and the attribution of each
kernel to the op and ``record_function`` ranges that launched it
(``profile``, lines 1000-1060). Kernels the port launches through ctypes
(the flash kernels) sit under no op, and are grouped by their name alone,
as there.
"""

from __future__ import annotations

import heapq
import time

import torch

#: the ``record_function`` ranges the harness opens around the program's
#: calls; the profiler shows each as a device-side span, which is not a
#: kernel
RANGES = ("moe_ffn",)
#: ``family_group``'s groups that the glue readers take
GLUE = "other (norms, RoPE, conv, SiLU, casts, embedding)"
MOE_GLUE = ("MoE dispatch / combine glue (softmax, sort, cumsum, scatter, "
            "gather)")


def is_gemm(kernel: str) -> bool:
    return any(s in kernel.lower()
               for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass"))


def is_flash_forward(kernel: str) -> bool:
    """A launch of a forward flash kernel: ``flash_sm90_kernel`` (8a) or
    ``flash_tf32_kernel`` (8b)."""
    return "flash_sm90_kernel" in kernel or "flash_tf32_kernel" in kernel


def family_group(kernel: str, ranges) -> str:
    """The group of a kernel, from its name and the names of the ops and
    ``record_function`` ranges it ran under (``moe_ffn``, ``ssd_chunked``)."""
    if is_flash_forward(kernel):
        return "attention (flash_attention kernels)"
    if "ssd_chunked" in ranges:
        return "SSD (ssd_chunked: products, masks, exps, the recurrence)"
    if "moe_ffn" in ranges:
        return ("expert products (and the router's)" if is_gemm(kernel)
                else MOE_GLUE)
    if is_gemm(kernel):
        return "other matrix products (projections, LM head)"
    return GLUE


def ranged(name: str, fn):
    """``fn`` run under a ``record_function`` range named ``name``."""
    def run(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return run


class Tracer:
    """``start`` and ``stop`` bracket the traced stretch (no-ops unless
    ``enabled``; the first ``start`` and ``stop`` only); ``summary()``
    reduces the trace."""

    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled, self.cuda = enabled, cuda
        self._prof = None
        self._t0 = 0.0
        self._window_s: float | None = None

    def start(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._prof is None or self._window_s is not None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self._window_s = time.perf_counter() - self._t0
        self._prof.stop()

    def summary(self) -> dict | None:
        """The reduced trace (None if nothing was traced)."""
        if self._window_s is None:
            return None
        return reduce(self._prof.events(), self._window_s)


def reduce(events, window_s: float, top: int = 10) -> dict:
    """The profile's events -> ``window_s``; ``busy_s``, the union of the
    device's operations; ``kernels`` and ``launches`` by name; ``groups``,
    seconds by ``family_group``; ``ranged``, seconds by (group, range) for
    the harness's ranges; the ``top`` device operations by time and the
    ``top`` idle gaps by what the host was doing meanwhile."""
    from torch.autograd import DeviceType
    kernels: dict[str, float] = {}
    launches: dict[str, int] = {}
    spans = []
    cpu = []
    for ev in events:
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            if ev.name in RANGES:
                continue
            dur = (tr.end - tr.start) / 1e6
            kernels[ev.name] = kernels.get(ev.name, 0.0) + dur
            launches[ev.name] = launches.get(ev.name, 0) + 1
            spans.append((tr.start, tr.end))
        elif ev.device_type == DeviceType.CPU:
            cpu.append((tr.start, tr.end, ev.name))

    # each kernel under the op that launched it, an op counted once; the
    # rest (ctypes launches, under no op) by name alone
    groups: dict[str, float] = {}
    in_range: dict[tuple[str, str], float] = {}
    tied: dict[str, float] = {}
    seen = set()
    for ev in events:
        launched = [k for k in getattr(ev, "kernels", ())
                    if k.name not in RANGES]
        if ev.device_type != DeviceType.CPU or not launched or ev.id in seen:
            continue
        seen.add(ev.id)
        names, up = [], ev
        while up is not None:
            names.append(up.name)
            up = up.cpu_parent
        for kern in launched:
            g = family_group(kern.name, names)
            s = kern.duration / 1e6
            groups[g] = groups.get(g, 0.0) + s
            tied[kern.name] = tied.get(kern.name, 0.0) + s
            for r in RANGES:
                if r in names:
                    in_range[(g, r)] = in_range.get((g, r), 0.0) + s
    for name, s in kernels.items():
        rest = s - tied.get(name, 0.0)
        if rest > 0:
            g = family_group(name, [])
            groups[g] = groups.get(g, 0.0) + rest

    busy, gaps = _union(spans)
    lo = min((c[0] for c in cpu), default=0.0)
    hi = max((c[1] for c in cpu), default=0.0)
    if spans:
        gaps = [(lo, min(s for s, _ in spans))] + gaps + \
            [(max(e for _, e in spans), hi)]
    by_host = _by_host(cpu, [g for g in gaps if g[1] > g[0]])
    return {
        "window_s": window_s, "busy_s": busy / 1e6,
        "device_s": sum(kernels.values()),
        "kernels": kernels, "launches": launches, "groups": groups,
        "ranged": in_range,
        "device_ops": sorted(([n, s] for n, s in kernels.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([n, s] for n, s in by_host.items()),
                            key=lambda kv: -kv[1])[:top],
    }


def _union(spans):
    """(total length, gaps between) of the union of intervals."""
    total, gaps = 0.0, []
    end = None
    for s, e in sorted(spans):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def _by_host(cpu, gaps) -> dict[str, float]:
    """Seconds of the idle gaps by what the host was doing at each gap's
    middle: the innermost (latest-starting) host event still running then,
    in one sweep over both in time order."""
    out: dict[str, float] = {}
    cpu = sorted(cpu)
    heap: list = []
    j = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        t = (a + b) / 2
        while j < len(cpu) and cpu[j][0] <= t:
            heapq.heappush(heap, (-cpu[j][0], cpu[j][1], cpu[j][2]))
            j += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "host Python, no op"
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out

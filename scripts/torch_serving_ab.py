#!/usr/bin/env python3
"""Compare the PyTorch port's SNN serving in two source trees on one card.

    python3 scripts/torch_serving_ab.py --trees OLD NEW --rounds 3

A tree is a checkout's root (``src/repro_torch`` below it), for example a
parent commit unpacked with ``git archive`` into a git-ignored directory.
Each round runs the trees in the order OLD NEW NEW OLD, each in a process of
its own (``--one TREE``), which builds the tree's SNN kernels into the
tree's own ``build/kernels/`` (cached after the first), serves every path
once on 256 images to warm up, and then:

  * serves the 10,000 procedural MNIST test images through the five SNN
    serving paths of chip_smoke.py's phase 3 and keeps each path's system
    and accelerator µs per image (``SNNServeEngine``/``ServingScheduler``
    stats);
  * times one wrapper call of the fused kernels 1-3, ``event_accum``,
    ``spike_matmul``, ``lif_fused`` (on ``event_accum``'s currents, the
    staged path's movedim view) and ``ttfs_decode`` (on ``lif_fused``'s
    first[:, :n_out] and v[:, :n_out]) at the serving shape (B 64): the
    kernel alone and the
    wrapper's host time a call, 20 calls queued behind a spin kernel, median
    of 50, as chip_smoke.py's phase 7 does (``spike_matmul`` with the
    weights' K-major copy where the tree's wrapper takes one, as its batch
    path does); and, where the tree has one, the cached ``launch_plan``
    lookup;
  * times ``flash_attention`` (the split-TF32 kernel, csrc/flash_attention.cu)
    alone at Qwen3-8B's head shape (B 1, Hq 32, Hkv 8, S 4096, D 128,
    causal): in float32, and in bf16 with a d stride of 2 (inputs no TMA map
    describes), 5 calls queued behind a spin kernel, median of 10, as
    chip_smoke.py's phase 7 does.

Each process prints one JSON line; the last line of the whole run is one
JSON object with, per metric and tree, every sample, the median and the
spread (max - min). The card's name and power limit are printed before it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import timeit

SERVE_BATCH = 64
TIMING_RUNS = 50
BACK_TO_BACK = 20
SPIN_CYCLES = 20_000_000
WARM_IMAGES = 256
#: attention's samples and calls a sample (its launches take milliseconds)
ATTN_RUNS, ATTN_BACK = 10, 5
ATTN_ARCH, ATTN_S = "qwen3-8b", 4096


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def one(tree: str) -> dict:
    """The metrics of one tree, measured in this process."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch

    from repro_torch.core.artifact import Artifact
    from repro_torch.core.events import pack_events_batched
    from repro_torch.core.lowering import lower
    from repro_torch.core.ttfs import encode_ttfs, frames_from_times
    from repro_torch.data import mnist
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.event_accum import ops as ea
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_event_lif import ops
    from repro_torch.kernels.lif import ops as lif
    from repro_torch.kernels.spike_matmul import ops as smm
    from repro_torch.kernels.ttfs_decode import ops as dec
    from repro_torch.serving.scheduler import ServingScheduler
    from repro_torch.serving.snn_engine import SNNServeEngine

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: needs a card")
    dev = torch.device("cuda", torch.cuda.current_device())
    build.build([n for n in build.sources() if n != "flash_attention_sm90"])
    art = Artifact.load(os.path.join(tree, "src", "repro_torch", "assets",
                                     "mnist_ttfs.npz"))
    xte, _ = mnist.load("test")
    runs = {
        "event-fused full-T":
            lambda: SNNServeEngine(art, max_batch=SERVE_BATCH),
        "event-fused latency":
            lambda: SNNServeEngine(art, max_batch=SERVE_BATCH,
                                   latency_mode=True),
        "event-cuda full-T":
            lambda: SNNServeEngine(art, max_batch=SERVE_BATCH, kernel="cuda"),
        "event-cuda latency":
            lambda: SNNServeEngine(art, max_batch=SERVE_BATCH, kernel="cuda",
                                   latency_mode=True),
        "batch-cuda":
            lambda: ServingScheduler(art, spec="accelerator-batch",
                                     kernel="cuda", max_batch=SERVE_BATCH),
    }

    def serve(make, images) -> dict:
        eng = make()
        finish = eng.flush if hasattr(eng, "flush") else eng.drain
        eng.reset_stats()
        for img in images:
            eng.submit(img)
        finish()
        st = eng.stats()
        eng.close()
        return st

    for make in runs.values():
        serve(make, xte[:WARM_IMAGES])
    out = {}
    for run, make in runs.items():
        st = serve(make, xte)
        out[f"{run}: system us/image"] = st["system_us_per_image"]
        out[f"{run}: accelerator us/image"] = st["accel_us_per_image"]

    prog = lower(art, device=dev)
    times = encode_ttfs(torch.from_numpy(np.asarray(xte[:SERVE_BATCH],
                                                    np.float32)),
                        prog.T, prog.x_min).numpy()
    frames = pack_events_batched(times, prog.T, prog.e_max, device=dev)
    args = (frames.ids, frames.count, prog.w_padded, prog.thr_padded,
            prog.leak_shift)
    dec_kw = dict(n_out=prog.n_out, n_groups=prog.n_groups,
                  per_group=prog.per_group, fallback=prog.fallback)
    fns = {"fused_event_lif_decode":
               lambda: ops.fused_event_lif_decode(*args, **dec_kw),
           "fused_event_lif_early_exit":
               lambda: ops.fused_event_lif_early_exit(*args),
           "fused_event_lif": lambda: ops.fused_event_lif(*args),
           "event_accum": lambda: ea.event_accum(frames.ids, prog.w_padded)}
    view = ea.event_accum(frames.ids, prog.w_padded).movedim(1, 0)
    state = lif.lif_fused(view, prog.thr_padded, prog.leak_shift)
    first_l = state.first_spike[:, :prog.n_out]
    v_l = state.v_final[:, :prog.n_out]
    dkw = dict(n_groups=prog.n_groups, per_group=prog.per_group,
               sentinel=prog.T, fallback=prog.fallback)
    fns["lif_fused"] = lambda: lif.lif_fused(view, prog.thr_padded,
                                             prog.leak_shift)
    fns["ttfs_decode"] = lambda: dec.ttfs_decode(first_l, v_l, **dkw)
    raster = frames_from_times(torch.from_numpy(times).to(dev), prog.T)
    if hasattr(smm, "k_major"):
        w_t = smm.k_major(prog.w_padded)
        fns["spike_matmul"] = lambda: smm.spike_matmul(raster, prog.w_padded,
                                                       w_t=w_t)
    else:
        fns["spike_matmul"] = lambda: smm.spike_matmul(raster, prog.w_padded)
    def alone(fn, runs, back) -> tuple[float, float]:
        """(device ms of one call alone, host ms of one wrapper call):
        ``back`` calls queued behind a spin kernel, median of ``runs``."""
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        spin, on_card, host = SPIN_CYCLES, [], []
        while len(on_card) < runs:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            t0 = time.perf_counter()
            for _ in range(back):
                fn()
            queued = time.perf_counter() - t0
            primed = not start.query()
            end.record()
            end.synchronize()
            if not primed:
                if spin >= 64 * SPIN_CYCLES:
                    raise SystemExit("the launches could not be queued ahead "
                                     "of the card")
                spin *= 2
                continue
            on_card.append(start.elapsed_time(end) / back)
            host.append(1e3 * queued / back)
        return statistics.median(on_card), statistics.median(host)

    for kname, fn in fns.items():
        out[f"{kname}: alone ms"], out[f"{kname}: wrapper host ms"] = alone(
            fn, TIMING_RUNS, BACK_TO_BACK)
    cfg = get_config(ATTN_ARCH)
    g = torch.Generator(dev).manual_seed(ATTN_S)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)
    f32 = [torch.randn(1, h, ATTN_S, cfg.d_head, generator=g, device=dev)
           for h in heads]
    s2 = [torch.randn(1, h, ATTN_S, 2 * cfg.d_head, generator=g, device=dev)
          .to(torch.bfloat16)[..., ::2] for h in heads]
    for what, qkv in (("float32", f32), ("bf16 d stride 2", s2)):
        out[f"flash_attention {what}: alone ms"] = alone(
            lambda: fa.flash_attention(*qkv), ATTN_RUNS, ATTN_BACK)[0]
    if hasattr(ops, "launch_plan"):
        E, N = frames.ids.shape[2], prog.n_pad
        n = 100_000
        out["launch_plan lookup ms"] = 1e3 * timeit.timeit(
            lambda: ops.launch_plan(prog.T, E, N), number=n) / n
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--one", metavar="TREE",
                    help="measure this tree in this process (one JSON line)")
    opts = ap.parse_args()
    if opts.one:
        print(json.dumps(one(opts.one), sort_keys=True))
        return 0
    if not opts.trees:
        ap.error("--trees OLD NEW is required")
    old, new = opts.trees
    samples = {old: {}, new: {}}
    for r in range(opts.rounds):
        for tree in (old, new, new, old):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                raise SystemExit(f"{tree} (round {r}) exited "
                                 f"{proc.returncode}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            print(f"[ab] round {r} {tree}: {json.dumps(got, sort_keys=True)}",
                  flush=True)
            for key, x in got.items():
                samples[tree].setdefault(key, []).append(x)
    card = card_line()
    summary = {}
    for key in sorted(set(samples[old]) | set(samples[new])):
        summary[key] = {}
        for tree in (old, new):
            xs = samples[tree].get(key)
            if xs:
                summary[key][tree] = {"median": statistics.median(xs),
                                      "spread": max(xs) - min(xs),
                                      "samples": xs}
                print(f"[ab] {key:44s} {tree:20s} median "
                      f"{statistics.median(xs):.4f} spread "
                      f"{max(xs) - min(xs):.4f} over {len(xs)}")
    print(card)
    print(json.dumps({"card": card, "metrics": summary}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

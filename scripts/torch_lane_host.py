#!/usr/bin/env python3
"""Where a serving lane's host time goes, on the card: the main thread
against a worker thread.

    python3 scripts/torch_lane_host.py [--rounds 2] [--device cuda]

Two measurements over the 10,000 procedural MNIST test images at the
serving shape (``max_batch`` 64, the committed MNIST artifact, the fused
full-T kernel), each in turns within one process (inline, lane, lane,
inline, for ``--rounds`` rounds), so that they share one card and one host:

  1. the scheduler: ``ServingScheduler(workers=0)`` (the inline lane on the
     calling thread) against ``workers=1`` (one threaded lane on a stream of
     its own), every request submitted at once; wall and system µs per
     image;
  2. one threaded lane's own serve path (``_Lane.serve``, its stream
     entered), batch by batch over the 156 full batches, called on the main
     thread and on a new thread: the float32 TTFS encode on the host
     (``core.ttfs.encode_ttfs``) and event packing with its one
     host-to-device copy (``pack_events_batched``), each timed by a shim
     around the function the lane calls, the accelerator scope the lane
     reports (launch and the wait on its stream), and the rest (the labels'
     copy back, the overflow check).

Every line names the card and its power limit. The device must be a card:
on ``--device cpu`` the script runs the same steps for a rehearsal, and its
numbers are host numbers only.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import ttfs  # noqa: E402
from repro_torch.core.artifact import Artifact  # noqa: E402
from repro_torch.data import mnist  # noqa: E402
from repro_torch.serving import scheduler as sched_mod  # noqa: E402
from repro_torch.serving.scheduler import ServingScheduler  # noqa: E402

BATCH = 64
STEPS = ("encode", "pack", "accel", "rest")


def card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "CPU rehearsal (no card)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def scheduler_run(art, images, workers: int, device) -> tuple[float, dict]:
    s = ServingScheduler(art, workers=workers, max_batch=BATCH,
                         kernel="fused", device=device)
    t0 = time.perf_counter()
    for img in images:
        s.submit(img)
    s.drain()
    wall = time.perf_counter() - t0
    st = s.stats()
    s.close()
    return wall, st


class Timed:
    """A function that keeps the µs of each call."""

    def __init__(self, fn):
        self.fn, self.us = fn, []

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        self.us.append(1e6 * (time.perf_counter() - t0))
        return out


def step_times(lane, images) -> dict[str, list[float]]:
    """Each step of ``lane.serve``, timed over every full batch of
    ``images``."""
    encode = Timed(ttfs.encode_ttfs)
    pack = Timed(sched_mod.pack_events_batched)
    out = {k: [] for k in STEPS}
    ttfs.encode_ttfs, sched_mod.pack_events_batched = encode, pack
    try:
        for i in range(0, len(images) - BATCH + 1, BATCH):
            batch = np.ascontiguousarray(images[i:i + BATCH])
            t0 = time.perf_counter()
            delta = lane.serve(batch, BATCH, probe=True)
            total = 1e6 * (time.perf_counter() - t0)
            accel = 1e6 * delta["accel_s"]
            out["encode"].append(encode.us[-1])
            out["pack"].append(pack.us[-1])
            out["accel"].append(accel)
            out["rest"].append(total - encode.us[-1] - pack.us[-1] - accel)
    finally:
        ttfs.encode_ttfs, sched_mod.pack_events_batched = encode.fn, pack.fn
    return out


def in_thread(fn):
    box = {}
    t = threading.Thread(target=lambda: box.update(r=fn()))
    t.start()
    t.join(timeout=600)
    if t.is_alive():
        raise RuntimeError("the worker thread did not finish")
    return box["r"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--images", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no card: pass --device cpu to rehearse")
    card = card_line(device)
    art = Artifact.load(os.path.join(ROOT, "src", "repro_torch", "assets",
                                     "mnist_ttfs.npz"))
    images = mnist.load("test")[0][:a.images]
    print(f"[lane-host] torch {torch.__version__}, intra-op threads "
          f"{torch.get_num_threads()} (main), "
          f"{in_thread(torch.get_num_threads)} (a new thread), "
          f"{os.cpu_count()} CPUs — card: {card}")
    scheduler_run(art, images[:BATCH], 1, device)          # warm both paths
    scheduler_run(art, images[:BATCH], 0, device)
    for rnd in range(a.rounds):
        for workers in (0, 1, 1, 0):
            wall, st = scheduler_run(art, images, workers, device)
            print(f"[lane-host] round {rnd} workers={workers}: "
                  f"{len(images)} images in {wall:.3f} s wall "
                  f"({1e6 * wall / len(images):.2f} us/image), system "
                  f"{st['system_us_per_image']:.2f} us/image, accelerator "
                  f"{st['accel_us_per_image']:.2f} us/image, "
                  f"{st['batches']} batches — card: {card}")
    s = ServingScheduler(art, workers=1, max_batch=BATCH, kernel="fused",
                         device=device)
    lane = s.lanes[0]
    step_times(lane, images[:BATCH * 4])                   # warm
    for rnd in range(a.rounds):
        for where in ("main", "worker", "worker", "main"):
            if where == "main":
                got = step_times(lane, images)
            else:
                got = in_thread(lambda: step_times(lane, images))
            parts = ", ".join(f"{k} {statistics.median(v):.1f}"
                              for k, v in got.items())
            total = sum(statistics.median(v) for v in got.values())
            print(f"[lane-host] round {rnd} the lane's serve on the {where} "
                  f"thread, median us per batch of {BATCH} over "
                  f"{len(got['encode'])} batches: {parts}; sum "
                  f"{total:.1f} — card: {card}")
    s.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

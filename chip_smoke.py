#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure exits non-zero; nothing is caught):

  1. build   — compile every CUDA source of the main path with nvcc
               (sm_90a) and print its wall time and ptxas report;
  2. kernels — each kernel against its plain PyTorch version on the card, bit
               for bit (tolerance 0: all arithmetic is integer), at the MNIST
               serving shape (B = 64, with an all-PAD row) and on the eight
               adversarial fuzz artifacts packed from the golden spike times
               (leak_shift 31 with negative membranes, never-spiking rows,
               both decode fallbacks, tie-heavy rows), plus one 2,000-neuron
               layer that gives each thread four lanes;
  3. main path — SNNServeEngine on the card serves the 10,000 procedural
               MNIST test images in full-T and in latency mode, each with the
               launch counters set to 0 just before its requests and read
               just after its flush: the mode's kernel must have launched
               once per served batch, the other kernel never. Labels must
               equal the JAX reference's (exported in src/repro_torch/assets)
               and the port's SNNReference on the card. Outside the counted
               runs, the fuzz artifacts are served and run through the
               accelerator, and their labels, first-spike times, membranes
               and steps must equal tests/golden/;
  4. overflow — the MNIST artifact with e_max = 8 must reroute rows to the
               dense path and still return the reference labels;
  5. times   — per kernel at the serving shape: its device time alone (CUDA
               events around 20 back-to-back launches queued behind a spin
               kernel, so no host dispatch falls between them; median of 50
               such samples), the wrapper's host time per call, the time of
               one wrapper call as a caller pays it, its plain version's time
               (CUDA events around one call, median of 50), and the least
               time the card could take for the same work (bound).

The last lines are a ``kernels`` summary, one JSON object with every
kernel's numbers, the card's name and power limit, and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
ASSETS = os.path.join(SRC, "repro_torch", "assets")
GOLDEN = os.path.join(ROOT, "tests", "golden")
SOURCE = "src/repro_torch/csrc/fused_event_lif.cu"
REPLACES = {
    "fused_event_lif_decode":
        "src/repro/kernels/fused_event_lif/kernel.py:158",
    "fused_event_lif_early_exit":
        "src/repro/kernels/fused_event_lif/kernel.py:227",
}
#: NVIDIA H100 SXM peaks (data sheet): HBM bytes/s, and the 67 T/s float32
#: rate outside the tensor cores, against which the kernels' integer ALU
#: operations are counted. The card's int32 rate is lower (an SM has half as
#: many INT32 lanes as FP32 lanes), so the bound computed here is below the
#: true one: it never flatters a kernel
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
SERVE_BATCH = 64
TIMING_RUNS = 50
BACK_TO_BACK = 20
#: cycles the spin kernel holds the stream while launches are queued behind it
SPIN_CYCLES = 20_000_000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def sha256(a) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, SRC)

    from repro_torch.core.accelerator import SNNAccelerator
    from repro_torch.core.artifact import Artifact
    from repro_torch.core.events import pack_events_batched
    from repro_torch.core.lowering import lower
    from repro_torch.core.reference import SNNReference
    from repro_torch.core.ttfs import encode_ttfs
    from repro_torch.data import mnist
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_event_lif import ops, ref
    from repro_torch.serving.snn_engine import SNNServeEngine

    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")

    # ---------------------------------------------------------------- 1 build
    t0 = time.perf_counter()
    build.build(["fused_event_lif"])
    print(f"[build] nvcc wall {time.perf_counter() - t0:.2f} s")
    for log in build.build_logs.values():
        print(log.rstrip())

    # ------------------------------------------------------------ fixtures
    art = Artifact.load(os.path.join(ASSETS, "mnist_ttfs.npz"))
    exp = np.load(os.path.join(ASSETS, "mnist_ttfs_expected.npz"))
    xte, yte = mnist.load("test")
    check(sha256(xte) == str(exp["images_sha256"]),
          "procedural MNIST test images differ from the exported ones")
    check(art.fingerprint() == str(exp["artifact_fingerprint"]),
          "MNIST artifact fingerprint differs from the JAX export")
    prog = lower(art, device=dev)
    check(prog.fingerprint == str(exp["program_fingerprint"]),
          "program fingerprint differs from the JAX package's")
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        manifest = json.load(f)
    fuzz = []
    for seed in manifest["seeds"]:
        with np.load(os.path.join(ASSETS, f"fuzz_seed{seed}.npz")) as z:
            fart = Artifact.load(io.BytesIO(z["artifact"].tobytes()))
            images = z["images"]
        golden = dict(np.load(os.path.join(GOLDEN,
                                           f"conformance_seed{seed}.npz")))
        fprog = lower(fart, device=dev)
        check(fprog.fingerprint == manifest["program_fingerprints"][str(seed)],
              f"fuzz seed {seed}: program fingerprint differs from golden")
        fuzz.append((seed, fart, fprog, images, golden))

    # ------------------------------------------------------- 2 kernels vs plain
    def serve_batch_frames(p, images):
        times = encode_ttfs(torch.from_numpy(np.asarray(images, np.float32)),
                            p.T, p.x_min).numpy()
        return pack_events_batched(times, p.T, p.e_max, device=dev)

    mnist_imgs = np.array(xte[:SERVE_BATCH])
    mnist_imgs[-1] = 0.0                          # an all-PAD row
    cases = [("mnist", prog, serve_batch_frames(prog, mnist_imgs))]
    for seed, _, fprog, _, golden in fuzz:
        cases.append((f"fuzz{seed}", fprog,
                      pack_events_batched(golden["times"], fprog.T,
                                          fprog.e_max, device=dev)))
    # a 2,000-neuron layer (N_pad 2048: 512 threads x 4 lanes per thread)
    rng = np.random.RandomState(0)
    n_in, n_out, n_pad, T = 300, 2000, 2048, 16
    w = np.zeros((n_in, n_pad), np.int8)
    w[:, :n_out] = rng.randint(-127, 128, (n_in, n_out))
    thr = np.full((n_pad,), 2**31 - 1, np.int32)
    thr[:n_out] = rng.randint(50, 4000, n_out)
    wide_times = rng.randint(0, T + 1, (16, n_in))
    wide = dict(T=T, leak_shift=3, n_out=n_out, n_groups=16, per_group=125,
                fallback="membrane", w=torch.from_numpy(w).to(dev),
                thr=torch.from_numpy(thr).to(dev))
    wide_frames = pack_events_batched(wide_times, T, 64, device=dev)

    def kernel_args(p):
        return dict(T=p.T, leak_shift=p.leak_shift, n_out=p.n_out,
                    n_groups=p.n_groups, per_group=p.per_group,
                    fallback=p.fallback, w=p.w_padded, thr=p.thr_padded)

    max_err = {name: 0 for name in ops.LAUNCHES}
    no_spike = {"membrane": 0, "zero": 0}
    negative_v = 0
    for name, a, frames in ([(n, kernel_args(p), f) for n, p, f in cases]
                            + [("wide", wide, wide_frames)]):
        ids, count = frames.ids, frames.count
        dec = dict(n_out=a["n_out"], n_groups=a["n_groups"],
                   per_group=a["per_group"], fallback=a["fallback"])
        res, labels = ops.fused_event_lif_decode(
            ids, count, a["w"], a["thr"], a["leak_shift"], **dec)
        want = ref.fused_event_lif_decode_ref(
            ids, count, a["w"], a["thr"], a["leak_shift"], **dec)
        res_x, steps = ops.fused_event_lif_early_exit(
            ids, count, a["w"], a["thr"], a["leak_shift"])
        want_x = ref.fused_event_lif_early_exit_ref(
            ids, count, a["w"], a["thr"], a["leak_shift"])
        torch.cuda.synchronize()
        for kname, got, ref_out in (
                ("fused_event_lif_decode",
                 (res.first_spike, res.v_final, labels), want),
                ("fused_event_lif_early_exit",
                 (res_x.first_spike, res_x.v_final, steps), want_x)):
            err = max(int((g.long() - r.long()).abs().max()) if g.numel()
                      else 0 for g, r in zip(got, ref_out))
            max_err[kname] = max(max_err[kname], err)
            check(err == 0, f"{kname} differs from its plain version on "
                  f"{name} (max |err| {err})")
        negative_v += int((res.v_final[:, :a["n_out"]] < 0).sum())
        silent = (res.first_spike[:, :a["n_out"]] == a["T"]).all(dim=1)
        no_spike[a["fallback"]] += int(silent.sum())
        print(f"[kernels] {name}: B={ids.shape[0]} T={a['T']} "
              f"E_max={ids.shape[2]} N_pad={a['w'].shape[1]} "
              f"leak_shift={a['leak_shift']} fallback={a['fallback']} "
              f"events={int(count.sum())} no-spike rows={int(silent.sum())}: "
              f"bit-exact")
    check(negative_v > 0, "no negative membrane was exercised")
    check(no_spike["membrane"] > 0 and no_spike["zero"] > 0,
          "both decode fallbacks must be exercised")
    print(f"[kernels] negative membranes {negative_v}, no-spike rows per "
          f"fallback {no_spike}")

    # ------------------------------------------------------------ 3 main path
    served = {}
    launches = {}
    per_batch = {}
    for latency in (False, True):
        kname = ("fused_event_lif_early_exit" if latency
                 else "fused_event_lif_decode")
        (other,) = set(ops.LAUNCHES) - {kname}
        eng = SNNServeEngine(art, max_batch=SERVE_BATCH,
                             latency_mode=latency)
        eng.reset_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        for img in xte:
            eng.submit(img)
        done = eng.flush()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        reqs = [done[r] for r in sorted(done)]
        st = eng.stats()
        eng.close()
        launches[kname] = counts[kname]
        per_batch[kname] = counts[kname] / st["batches"]
        check(counts[kname] > 0, f"{kname} was never launched on the main "
              f"path")
        check(per_batch[kname] == 1.0, f"{kname}: {counts[kname]} launches "
              f"for {st['batches']} served batches, not one each")
        check(counts[other] == 0, f"{other} launched {counts[other]} times "
              f"in the {'latency' if latency else 'full-T'} run")
        labels = np.asarray([r.label for r in reqs], np.int32)
        steps = np.asarray([r.steps for r in reqs], np.int32)
        served[latency] = (labels, steps)
        mode = "latency" if latency else "full-T"
        print(f"[main] {mode}: {len(reqs)} images in {wall:.3f} s wall, "
              f"accuracy {np.mean(labels == yte):.4f}, mean steps "
              f"{steps.mean():.2f}, {kname} launches {counts[kname]} "
              f"({per_batch[kname]:.2f} per served batch)")
        print(f"[main] {mode} stats: {json.dumps(st, sort_keys=True)}")
    check(np.array_equal(served[False][0], exp["labels"]),
          "full-T served labels differ from the JAX reference labels")
    check(np.array_equal(served[True][0], exp["labels_latency"]),
          "latency-mode labels differ from the JAX latency labels")
    check(np.array_equal(served[True][1], exp["steps_latency"]),
          "latency-mode steps differ from the JAX latency steps")
    # correctness only, outside the counted runs: the launches below are not
    # the main path's
    for seed, fart, fprog, images, golden in fuzz:
        eng = SNNServeEngine(fart, max_batch=SERVE_BATCH)
        check(np.array_equal(eng.classify(images), golden["labels"]),
              f"fuzz seed {seed}: served labels differ from golden")
        eng.close()
        out = SNNAccelerator(fprog, mode="event", kernel="fused",
                             device=dev).forward(images)
        for key in ("labels", "first_spike", "v_final", "steps"):
            check(np.array_equal(getattr(out, key).cpu().numpy(),
                                 golden[key]),
                  f"fuzz seed {seed}: accelerator {key} differs from golden")
        out = SNNAccelerator(fprog, mode="event", kernel="fused",
                             device=dev).forward(images, latency_mode=True)
        check(np.array_equal(out.labels.cpu().numpy(), golden["labels"]),
              f"fuzz seed {seed}: latency-mode labels differ from golden")
    print(f"[main] fuzz seeds {manifest['seeds']}: labels, first_spike, "
          f"v_final, steps equal tests/golden/")

    ref_rt = SNNReference(art, device=dev)
    labels, first, v = [], [], []
    for i in range(0, len(xte), 1000):
        out = ref_rt.forward(xte[i:i + 1000])
        labels.append(out.labels.cpu().numpy())
        first.append(out.first_spike.cpu().numpy())
        v.append(out.v_final.cpu().numpy())
    check(np.array_equal(np.concatenate(labels), served[False][0]),
          "served labels differ from the port's SNNReference on the card")
    check(sha256(np.concatenate(first)) == str(exp["first_spike_sha256"]),
          "SNNReference first_spike differs from the JAX reference")
    check(sha256(np.concatenate(v)) == str(exp["v_final_sha256"]),
          "SNNReference v_final differs from the JAX reference")
    print("[main] SNNReference on the card: labels, first_spike and v_final "
          "equal the JAX reference on all 10,000 images")

    # ------------------------------------------------------------- 4 overflow
    meta = copy.deepcopy(art.meta)
    meta["events"]["e_max"] = 8
    small = Artifact(meta, dict(art.arrays))
    eng = SNNServeEngine(small, max_batch=SERVE_BATCH)
    got = eng.classify(xte[:SERVE_BATCH])
    st = eng.stats()
    eng.close()
    check(st["overflow_fallbacks"] > 0, "e_max=8 rerouted no row")
    check(np.array_equal(got, exp["labels"][:SERVE_BATCH]),
          "rerouted labels differ from the reference")
    print(f"[overflow] e_max=8: {st['overflow_fallbacks']} of {SERVE_BATCH} "
          f"rows rerouted to the dense path, labels equal the reference")

    # --------------------------------------------------------------- 5 times
    frames = serve_batch_frames(prog, xte[:SERVE_BATCH])
    ids, count = frames.ids, frames.count
    dec = dict(n_out=prog.n_out, n_groups=prog.n_groups,
               per_group=prog.per_group, fallback=prog.fallback)
    args = (ids, count, prog.w_padded, prog.thr_padded, prog.leak_shift)
    fns = {
        "fused_event_lif_decode": (
            lambda: ops.fused_event_lif_decode(*args, **dec),
            lambda: ref.fused_event_lif_decode_ref(*args, **dec)),
        "fused_event_lif_early_exit": (
            lambda: ops.fused_event_lif_early_exit(*args),
            lambda: ref.fused_event_lif_early_exit_ref(*args)),
    }

    def call_ms(fn) -> float:
        """One call as a caller pays it: CUDA events around the call, host
        dispatch included (median of TIMING_RUNS)."""
        for _ in range(5):
            fn()
        times = []
        for _ in range(TIMING_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def kernel_ms(fn) -> tuple[float, float]:
        """(device ms of one launch alone, host ms of one wrapper call).

        A spin kernel holds the stream while BACK_TO_BACK calls are queued
        behind the start event, so the events bracket kernels that run back
        to back with no host dispatch between them; a sample whose spin ended
        before the queue was full is taken again with a longer spin."""
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        spin = SPIN_CYCLES
        dev, host = [], []
        while len(dev) < TIMING_RUNS:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            t0 = time.perf_counter()
            for _ in range(BACK_TO_BACK):
                fn()
            queued = time.perf_counter() - t0
            primed = not start.query()
            end.record()
            end.synchronize()
            if not primed:
                check(spin < 64 * SPIN_CYCLES, "the launches could not be "
                      "queued ahead of the card")
                spin *= 2
                continue
            dev.append(start.elapsed_time(end) / BACK_TO_BACK)
            host.append(1e3 * queued / BACK_TO_BACK)
        return statistics.median(dev), statistics.median(host)

    # the work this batch needs: executed steps, their events, the distinct
    # weight rows they touch; 5 ALU operations per lane-step of the LIF update
    cnt = count.cpu().numpy().astype(np.int64)
    ids_h = ids.cpu().numpy()
    _, steps_x = ops.fused_event_lif_early_exit(*args)
    steps_h = steps_x.cpu().numpy()
    B, T_, E = ids_h.shape
    N = prog.n_pad
    work = {"fused_event_lif_decode": np.full(B, T_),
            "fused_event_lif_early_exit": steps_h}
    rows = []
    for kname, (kern, plain) in fns.items():
        run = work[kname]
        live = np.arange(T_)[None, :] < run[:, None]           # (B, T)
        events = int((cnt * live).sum())
        used = np.zeros(prog.n_in, bool)
        for b in range(B):
            for t in range(int(run[b])):
                used[ids_h[b, t, :cnt[b, t]]] = True
        n_bytes = (4 * events + 4 * int(live.sum()) + int(used.sum()) * N
                   + 4 * N + 2 * 4 * B * N + 4 * B)
        n_ops = events * N + 5 * int(live.sum()) * N
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S
        (ms, host_ms), whole_ms = kernel_ms(kern), call_ms(kern)
        plain_ms = call_ms(plain)
        rows.append({"name": kname, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[kname],
                     "launches": int(launches[kname]),
                     "max_abs_err": max_err[kname], "ms": ms,
                     "plain_ms": plain_ms,
                     "bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": None})
        print(f"[times] {kname}: B={B} T={T_} E_max={E} N_pad={N} events "
              f"{events}: kernel alone {ms:.4f} ms, wrapper host "
              f"{host_ms:.4f} ms per call, one call {whole_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {rows[-1]['bound_ms']:.6f} ms "
              f"({rows[-1]['bound_by']}: {n_bytes} B, {n_ops} ops), launches "
              f"per served batch {per_batch[kname]:.2f} — card: {card}")

    print("kernels " + " ".join(f"{r['name']}={r['launches']}" for r in rows))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

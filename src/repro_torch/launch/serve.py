"""Serving launcher of the port: --arch <id> (an LM) or --snn-artifact (the
SNN classifier, with its leader/follower program distribution).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \\
        --requests 16 --max-new 12 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
        --reduced --device cpu      # also mamba2-780m, jamba-1.5-large-398b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --reduced --device cpu      # also internvl2-26b

LM parameters are drawn in float32 from a seeded generator, as the JAX
launcher draws them (``repro.launch.serve``); the prompts are JAX's, from
``numpy.random.RandomState(0)``, text only: Whisper decodes against its
zero cross cache and InternVL without patches, as JAX's launcher serves
them.

SNN multi-host mode (lower once per process group): point every process at
the same exported artifact and a transport — the leader lowers and
publishes, followers fetch + verify and never lower. ``--transport`` takes
``tcp://HOST:PORT`` (network, real multi-host) or a shared filesystem path
(``--program-envelope`` is the legacy spelling of the latter). The wire and
the envelope are the JAX package's, so either package's follower reads
either's leader.

    # leader (port 0 = ephemeral; the chosen endpoint is printed)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --snn-artifact src/repro_torch/assets/mnist_ttfs.npz \\
        --transport tcp://127.0.0.1:0 --role leader --await-fetches 1 \\
        --requests 10000 --labels-out leader.npy
    # follower, on any host that holds the same artifact
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --snn-artifact src/repro_torch/assets/mnist_ttfs.npz \\
        --transport tcp://LEADER:PORT --role follower --requests 10000 \\
        --labels-out follower.npy

Both serve JAX's request stream, ``RandomState(0).rand(requests, n_in)`` in
float32, through ``SNNServeEngine`` on the fused kernels, on ``--device``
(the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced as make_reduced
from repro_torch.core.lowering import resolve_device
from repro_torch.models.model import LM
from repro_torch.serving.engine import ServeEngine


def serve_snn(args, t0: float) -> None:
    """The SNN leader/follower path: distribute the program, then serve.
    ``t0`` is the launcher's start on ``time.perf_counter``; the wall
    seconds to the program, the first served label and the last are
    reported from it."""
    from repro_torch.core.artifact import Artifact
    from repro_torch.core.lowering import get_cache
    from repro_torch.launch.cluster import LeaderHandle, distribute_program
    from repro_torch.launch.mesh import broadcast_program
    from repro_torch.serving.snn_engine import SNNServeEngine

    dev = resolve_device(args.device)
    art = Artifact.load(args.snn_artifact)
    transport = args.transport or args.program_envelope
    if transport:
        prog, handle = distribute_program(art, transport, role=args.role,
                                          timeout_s=args.envelope_timeout,
                                          device=dev)
        if handle.endpoint is not None:
            print(f"[{args.role}] publishing program at {handle.endpoint}",
                  flush=True)
    else:
        prog = broadcast_program(art, leader=args.role == "leader",
                                 device=dev)
        handle = LeaderHandle()
    program_s = time.perf_counter() - t0
    engine = SNNServeEngine(art, max_batch=args.max_batch, device=dev)
    rng = np.random.RandomState(0)
    images = rng.rand(args.requests, prog.n_in).astype(np.float32)
    # the first batch alone, then the rest: the batches are the ones one
    # classify of every request forms, and the first label's time is read
    first = engine.classify(images[:args.max_batch])
    first_label_s = time.perf_counter() - t0
    labels = np.concatenate([first, engine.classify(images[args.max_batch:])])
    all_labels_s = time.perf_counter() - t0
    st = engine.stats()
    engine.close()
    if args.labels_out:
        np.save(args.labels_out, labels)
    if args.await_fetches > 0:
        ok = handle.await_fetches(args.await_fetches,
                                  timeout_s=args.envelope_timeout)
        state = "served" if ok else "TIMED OUT awaiting"
        print(f"[{args.role}] {state} {handle.serves}/"
              f"{args.await_fetches} follower fetch(es)")
    handle.stop()
    cs = get_cache().stats()
    transport_st = {k: v for k, v in st.items() if k.startswith("transport_")}
    print(f"[{args.role}] program after {program_s:.3f} s, first label after "
          f"{first_label_s:.3f} s, all labels after {all_labels_s:.3f} s of "
          f"wall on {dev}")
    print(f"[{args.role}] transport {json.dumps(transport_st, sort_keys=True)}")
    print(f"[{args.role}] served {args.requests} requests; "
          f"program {prog.fingerprint[:12]}... "
          f"(cache: {cs['program_misses']} lowered, "
          f"{cs['bytes']} bytes resident)")


def main(argv: list[str] | None = None) -> dict | None:
    """Serve an LM (returns its engine's ``stats()``) or, with
    ``--snn-artifact``, the SNN classifier in its transport role."""
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--snn-artifact",
                    help="serve an exported SNN artifact instead of an LM")
    ap.add_argument("--program-envelope",
                    help="shared path for the serialized program envelope "
                         "(legacy spelling of --transport PATH)")
    ap.add_argument("--transport",
                    help="program distribution endpoint: tcp://HOST:PORT "
                         "or a shared filesystem path")
    ap.add_argument("--role", choices=("leader", "follower"),
                    default="leader")
    ap.add_argument("--envelope-timeout", type=float, default=30.0)
    ap.add_argument("--await-fetches", type=int, default=0,
                    help="leader: block until N followers fetched the "
                         "program before tearing the endpoint down")
    ap.add_argument("--labels-out",
                    help="save served labels to this .npy (the two-process "
                         "bit-exactness gate compares them)")
    args = ap.parse_args(argv)

    if args.snn_artifact:
        serve_snn(args, t0)
        return None
    if not args.arch:
        ap.error("--arch is required unless --snn-artifact is given")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    lm = LM(cfg, dtype=torch.float32, device=dev)
    lm.init_params(torch.Generator(dev).manual_seed(0))
    engine = ServeEngine(lm, max_batch=args.max_batch, s_max=256,
                         device=dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, rng.randint(4, 16)).astype(np.int32)
               for _ in range(args.requests)]
    outs = engine.generate(prompts, max_new=args.max_new)
    st = engine.stats()
    print(f"served {len(outs)} requests on {dev}; "
          f"accelerator {st['accelerator_s']:.2f}s / "
          f"system {st['system_s']:.2f}s, {st['tokens_out']} tokens out")
    return st


if __name__ == "__main__":
    main()

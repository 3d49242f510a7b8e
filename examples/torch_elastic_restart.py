"""Fault-tolerance demo on the PyTorch/CUDA port (the counterpart of
``elastic_restart.py``): kill/restore + host churn + straggler response.

Simulates a 4-host data-parallel training job in-process:
  1. trains with deterministic per-host data shards,
  2. "crashes" after step 5 (state discarded),
  3. restores from the atomic checkpoint and replays to step 10 —
     asserts the trajectory is bit-identical to an uninterrupted run,
  4. kills host h2: rendezvous reassignment moves ONLY h2's shards,
  5. a straggler appears: work shares rebalance inversely to speed.

    PYTHONPATH=src python examples/torch_elastic_restart.py
    PYTHONPATH=src python examples/torch_elastic_restart.py --device cpu

The checkpoint goes under ``--ckpt-dir`` (a new temporary directory by
default). On the card the steps run under deterministic algorithms, so that
the replay repeats the uninterrupted run bit for bit.
"""

import argparse
import os
import tempfile
import warnings

import torch

from repro_torch.configs.registry import get_config, reduced
from repro_torch.core.lowering import resolve_device
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models.convert import leaf_groups, lm_to_jax, load_jax
from repro_torch.models.model import LM
from repro_torch.training import lm_step, optim as O
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.elastic import (StragglerMonitor, rebalance,
                                          shard_assignment)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None,
                    help="the checkpoint's directory (default: a new "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_elastic_demo_")

    cfg = reduced(get_config("yi-6b"))
    optimizer = O.adamw(lr=1e-3)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=32,
                                             global_batch=8, n_hosts=4))

    def fresh():
        """The model at step 0 (seed 0), its optimiser state and step."""
        lm = LM(cfg, dtype=torch.float32, device=dev)
        lm.init_params(torch.Generator(dev).manual_seed(0))
        return lm, lm_step.make_opt_state(lm, optimizer), \
            lm_step.make_train_step(lm, optimizer)

    def train(step, state, steps):
        for i in steps:
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.global_batch_at(i).items()}
            state, _ = step(state, batch)
        return state

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(dev.type == "cuda",
                                           warn_only=True)
        try:
            # --- uninterrupted run (ground truth) ------------------------
            lm, o, step = fresh()
            train(step, o, range(10))
            truth = [g.leaf for g in leaf_groups(lm)]

            # --- crash at 5, restore, replay -----------------------------
            mgr = CheckpointManager(ckpt, keep=1)
            lm, o, step = fresh()
            o = train(step, o, range(5))
            mgr.save(5, {"params": lm_to_jax(lm), "opt": o})
            print("step 5: checkpoint saved; simulating crash (state "
                  "dropped)")
            del lm, o, step

            lm, o, step = fresh()
            at, restored = mgr.restore({"params": lm_to_jax(lm), "opt": o},
                                       device=dev)
            load_jax(lm, restored["params"])
            o = restored["opt"]
            print(f"restored at step {at}; data pipeline regenerates shards "
                  "deterministically per (seed, step, host)")
            train(step, o, range(at, 10))
        finally:
            torch.use_deterministic_algorithms(False)
    ok = all(torch.equal(a, g.leaf)
             for a, g in zip(truth, leaf_groups(lm)))
    print(f"post-restore trajectory bit-identical to uninterrupted run: {ok}")
    assert ok

    # --- host failure: minimal-movement reassignment -----------------------
    hosts = ["h0", "h1", "h2", "h3"]
    assign = shard_assignment(hosts, 16)
    new, moved = rebalance(assign, ["h0", "h1", "h3"])
    print(f"h2 died: {len(moved)}/{16} shards moved "
          f"(only h2's: {moved}); survivors keep their shards")

    # --- straggler mitigation ----------------------------------------------
    mon = StragglerMonitor()
    for _ in range(10):
        for h, t in [("h0", 1.0), ("h1", 1.02), ("h3", 0.98), ("h2*", 2.4)]:
            mon.record(h, t)
    shares = mon.work_shares(["h0", "h1", "h3", "h2*"])
    print(f"stragglers detected: {mon.stragglers()}; "
          f"rebalanced work shares: "
          + ", ".join(f"{h}={s:.2f}" for h, s in sorted(shares.items())))
    print("demo complete.")
    return {"bit_identical": ok, "restored_at": at, "moved": moved,
            "stragglers": mon.stragglers(), "shares": shares,
            "ckpt": os.path.abspath(ckpt)}


if __name__ == "__main__":
    main()

"""LM training driver on the PyTorch/CUDA port (the counterpart of
``train_lm.py``): synthetic-token pretraining with checkpoints, gradient
compression, and fault-tolerant restart.

The paper's kind is deployment/inference, so the end-to-end driver is
torch_train_ttfs_mnist.py; this driver exercises the port's *training*
substrate on the LM zoo. The default config is CPU-sized; --size 100m
selects a ~100M-param model (12L x d768, GQA 12/4) in bf16 for a few hundred
steps on the card.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 60
    PYTHONPATH=src python examples/torch_train_lm.py --size 100m --steps 300
    # kill it mid-run, then re-run with the same args: it resumes.
    PYTHONPATH=src python examples/torch_train_lm.py --steps 6 --device cpu

The model is drawn from seed 0 (JAX's example draws from ``PRNGKey(0)``:
the numbers differ) and updated in place by the port's train step;
checkpoints hold JAX's tree (``{"params", "opt"}``) under ``--ckpt-dir``
(``repro_torch_lm_ckpt`` in the temporary directory by default).
"""

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs.registry import get_config, reduced
from repro_torch.core.lowering import resolve_device
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models.convert import leaf_groups, lm_to_jax, load_jax
from repro_torch.models.model import LM
from repro_torch.training import lm_step, optim as O
from repro_torch.training.checkpoint import CheckpointManager


def pick_config(size: str):
    base = get_config("qwen3-8b")
    if size == "tiny":
        return dataclasses.replace(reduced(base), name="lm-tiny")
    if size == "100m":
        return dataclasses.replace(
            base, name="lm-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, d_head=64, d_ff=2048, vocab=32000, remat=False)
    raise ValueError(size)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = pick_config(args.size)
    lm = LM(cfg, dtype=torch.float32 if args.size == "tiny"
            else torch.bfloat16, device=dev)
    lm.init_params(torch.Generator(dev).manual_seed(0))
    n_params = sum(g.leaf.numel() for g in leaf_groups(lm))
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params")

    optimizer = O.get(cfg.optimizer, 3e-4)
    opt_state = lm_step.make_opt_state(lm, optimizer, args.compress_grads)
    step_fn = lm_step.make_train_step(lm, optimizer,
                                      compress_grads=args.compress_grads)

    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    start = 0
    if mgr.latest_step() is not None:
        start, restored = mgr.restore({"params": lm_to_jax(lm),
                                       "opt": opt_state}, device=dev)
        load_jax(lm, restored["params"])
        opt_state = restored["opt"]
        print(f"resumed from checkpoint at step {start} (fault-tolerant path)")

    t0 = time.time()
    metrics = None
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.global_batch_at(i).items()}
        opt_state, metrics = step_fn(opt_state, batch)
        if (i + 1) % 10 == 0 or i == start:
            tok_s = args.batch * args.seq * (i + 1 - start) / (time.time() - t0)
            print(f"step {i + 1:4d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  {tok_s:,.0f} tok/s")
        if (i + 1) % args.ckpt_every == 0:
            path = mgr.save(i + 1, {"params": lm_to_jax(lm), "opt": opt_state},
                            meta={"loss": float(metrics["loss"])})
            print(f"  checkpoint -> {os.path.basename(path)}")
    print("done.")
    return {"start": start, "steps": args.steps, "metrics": metrics,
            "n_params": n_params, "checkpoints": mgr.all_steps()}


if __name__ == "__main__":
    main()

"""Training launcher of the port: --arch <id>, the port of
``repro.launch.train`` with the same flags plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --reduced --steps 30 --ckpt /tmp/ck --compress-grads --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
        --steps 3 --batch 4 --seq 448          # the card

The model is drawn in float32 from a seeded generator (JAX's launcher
initialises float32 parameters too, from its own key: the numbers differ),
trained with ``cfg.optimizer`` at ``--lr`` on ``TokenPipeline``'s batch of
each step, and checkpointed every ``--ckpt-every`` steps in JAX's format
(``training.checkpoint``: ``{"params", "opt"}``, the last two kept). With a
checkpoint in ``--ckpt`` it resumes from the latest one, and because the
token stream is a pure function of the step, a run resumed at step n gives
the parameters of a run never stopped. The step lines are JAX's. An
encoder-decoder (Whisper) is also fed frames (B, cross_len, d) drawn from
``RandomState(step)``, which JAX's launcher does not do (its ``loss`` would
fail in ``encode``).

``Trainer`` is the loop a step at a time, for callers that time, count or
checkpoint steps themselves (``chip_smoke.py``); ``main`` runs it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced as make_reduced
from repro_torch.core.lowering import resolve_device
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import load_jax, lm_to_jax
from repro_torch.models.model import LM
from repro_torch.training import lm_step, optim as O
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.elastic import StragglerMonitor


class Trainer:
    """One training run of ``cfg``: the float32 model drawn from seed 0 (JAX's
    launcher draws from ``PRNGKey(0)``), its optimiser state and train
    step, the token stream, the checkpoint manager (``ckpt``) and a
    straggler monitor. Built on a directory that holds a checkpoint, it
    resumes from the latest (``start``)."""

    def __init__(self, cfg: ArchConfig, *, batch: int = 8, seq: int = 64,
                 grad_accum: int = 1, compress_grads: bool = False,
                 ckpt: str | None = None, ckpt_every: int = 10,
                 lr: float = 3e-4, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lm = LM(cfg, dtype=torch.float32, device=self.device)
        self.lm.init_params(torch.Generator(self.device).manual_seed(0))
        self.optimizer = O.get(cfg.optimizer, lr)
        self.opt_state = lm_step.make_opt_state(self.lm, self.optimizer,
                                                compress_grads)
        self.step_fn = lm_step.make_train_step(
            self.lm, self.optimizer, grad_accum=grad_accum,
            compress_grads=compress_grads)
        self.pipe = TokenPipeline(TokenPipelineConfig(
            vocab=cfg.vocab, seq_len=seq, global_batch=batch))
        self.mgr = CheckpointManager(ckpt, keep=2) if ckpt else None
        self.ckpt_every = ckpt_every
        self.mon = StragglerMonitor()
        self.start = 0
        if self.mgr and self.mgr.latest_step() is not None:
            self.start = self.restore()
            print(f"[resume] restored step {self.start}")

    def batch_at(self, i: int) -> dict:
        """Step ``i``'s batch on the device: ``tokens``, ``labels`` and,
        for an encoder-decoder, ``enc_frames``."""
        b = {k: torch.from_numpy(v).to(self.device)
             for k, v in self.pipe.global_batch_at(i).items()}
        if self.cfg.enc_layers:
            B = b["tokens"].shape[0]
            frames = np.random.RandomState(i).randn(
                B, self.cfg.cross_len, self.cfg.d_model).astype(np.float32)
            b["enc_frames"] = torch.from_numpy(frames).to(self.device)
        return b

    def step(self, i: int, batch: dict | None = None) -> dict:
        """Train step ``i`` (0-based) -> its metrics; prints JAX's step line
        and saves a checkpoint where JAX's loop would."""
        t0 = time.perf_counter()
        batch = self.batch_at(i) if batch is None else batch
        self.opt_state, metrics = self.step_fn(self.opt_state, batch)
        loss = float(metrics["loss"])       # waits for the device
        dt = time.perf_counter() - t0
        self.mon.record("host0", dt)
        if (i + 1) % 5 == 0 or i == self.start:
            print(f"step {i + 1:4d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  {dt:.2f}s/step")
        if self.mgr and (i + 1) % self.ckpt_every == 0:
            self.save(i + 1, loss)
        return metrics

    def state(self) -> dict:
        """The train state in JAX's tree: ``{"params", "opt"}``."""
        return {"params": lm_to_jax(self.lm), "opt": self.opt_state}

    def save(self, step: int, loss: float) -> str:
        return self.mgr.save(step, self.state(),
                             meta={"loss": loss, "arch": self.cfg.name})

    def restore(self, step: int | None = None) -> int:
        """Load a checkpoint (the latest by default) into the model and the
        optimiser state; returns its step."""
        step, restored = self.mgr.restore(self.state(), step,
                                          device=self.device)
        load_jax(self.lm, restored["params"])
        self.opt_state = restored["opt"]
        return step

    def run(self, steps: int) -> dict | None:
        """Steps ``start`` .. ``steps`` - 1; the last step's metrics."""
        metrics = None
        for i in range(self.start, steps):
            metrics = self.step(i)
        if self.mon.stragglers():
            print(f"[straggler report] {self.mon.stragglers()}")
        print("training complete.")
        return metrics


def main(argv: list[str] | None = None) -> dict | None:
    """Train ``--arch`` for ``--steps`` steps; returns the last step's
    metrics (None when a checkpoint already reached them)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    trainer = Trainer(cfg, batch=args.batch, seq=args.seq,
                      grad_accum=args.grad_accum,
                      compress_grads=args.compress_grads, ckpt=args.ckpt,
                      ckpt_every=args.ckpt_every, lr=args.lr,
                      device=args.device)
    return trainer.run(args.steps)


if __name__ == "__main__":
    main()

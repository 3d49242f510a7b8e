"""Training for the paper's TTFS classifier (784 -> 150, 10 groups x 15).

The port of ``repro.training.ttfs_trainer``: the same two trainers, in
autograd, with the same batch order (``np.random.RandomState(seed)
.permutation`` per epoch) and the same AdamW (``training.optim``).

  * ``train_dense_proxy`` — the deployed path. Cross-entropy on group-mean
    logits of the dense execution W·x. Export then quantizes and calibrates
    thresholds; TTFS accuracy lands slightly below dense accuracy.
  * ``train_surrogate`` — a temporal trainer: differentiable LIF simulation
    in float with a sigmoid surrogate spike gradient and a soft-TTFS
    (earliest-spike) readout.

Each takes ``device`` (default ``"cuda"``) and an optional initial weight
``w_init`` ((n_in, n_out), e.g. the JAX package's init carried across);
without it the weights are drawn from a ``torch.Generator`` seeded by
``seed``. The products are float32 with PyTorch's default (TF32 off), and
the trainers leave every global flag as they found it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import snn
from repro_torch.core.lowering import resolve_device
from repro_torch.training import optim as O


@dataclasses.dataclass
class TrainResult:
    model: snn.SNN
    train_acc: float
    test_acc: float
    steps: int
    wall_s: float
    #: the training loss of every step, in order (the JAX package's
    #: trainers compute it and drop it)
    losses: list[float] = dataclasses.field(default_factory=list)


def _group_logits(z: torch.Tensor, g: int, p: int) -> torch.Tensor:
    return z.reshape(z.shape[0], g, p).mean(dim=-1)


def _cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def _initial_weight(n_in: int, n_out: int, seed: int, w_init, draw
                    ) -> torch.Tensor:
    """``w_init`` as float32, else ``draw(generator)`` from a CPU generator
    seeded by ``seed``."""
    if w_init is not None:
        w = snn.float32_copy(w_init)
        if tuple(w.shape) != (n_in, n_out):
            raise ValueError(f"w_init of shape {tuple(w.shape)}, expected "
                             f"{(n_in, n_out)}")
        return w
    return draw(torch.Generator().manual_seed(seed))


def _fit(loss_fn, w: torch.Tensor, images: torch.Tensor,
         labels: torch.Tensor, *, epochs: int, batch: int, lr: float,
         seed: int) -> tuple[torch.Tensor, list[float]]:
    """AdamW (weight decay 1e-4) over ``epochs`` shuffled passes, dropping
    the last partial batch; returns (w, the loss of each step)."""
    opt = O.adamw(lr=lr, weight_decay=1e-4)
    params = {"w": w}
    state = opt.init(params)
    n = len(images)
    rng = np.random.RandomState(seed)
    losses = []
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(images.device)
        for i in range(0, n - batch + 1, batch):
            idx = order[i:i + batch]
            w = params["w"].requires_grad_(True)
            loss = loss_fn(w, images[idx], labels[idx])
            (grad,) = torch.autograd.grad(loss, w)
            params, state = opt.update({"w": grad}, state,
                                       {"w": w.detach()})
            losses.append(loss.detach())
    return params["w"], torch.stack(losses).tolist() if losses else []


def _model(w: torch.Tensor, readout: snn.ReadoutSpec, t_steps: int,
           device: torch.device, **lif) -> snn.SNN:
    lin = snn.Linear(w.shape[0], w.shape[1], device=device)
    lin.set_weight(w)
    return snn.SNN(snn.Sequential(lin, snn.LIF(t_steps=t_steps, **lif)),
                   readout=readout, encode_t=t_steps)


@torch.no_grad()
def _accuracy(predict, x: torch.Tensor, y: torch.Tensor,
              chunk: int = 2048) -> float:
    preds = torch.cat([predict(x[i:i + chunk])
                       for i in range(0, len(x), chunk)])
    return float(np.mean(preds.cpu().numpy() == y.cpu().numpy()))


def train_dense_proxy(images: np.ndarray, labels: np.ndarray, *,
                      test_images: np.ndarray | None = None,
                      test_labels: np.ndarray | None = None,
                      epochs: int = 5, batch: int = 256, lr: float = 3e-3,
                      seed: int = 0, t_steps: int = 32,
                      readout: snn.ReadoutSpec | None = None,
                      w_init: np.ndarray | None = None,
                      device: str | torch.device = "cuda") -> TrainResult:
    t0 = time.perf_counter()
    dev = resolve_device(device)
    readout = readout or snn.ReadoutSpec()
    g, p = readout.n_groups, readout.per_group
    n_in, n_out = images.shape[1], g * p
    w0 = _initial_weight(
        n_in, n_out, seed, w_init,
        lambda gen: snn.Linear(n_in, n_out, device="cpu").init(gen))
    x = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)

    def loss_fn(w, xb, yb):
        return _cross_entropy(_group_logits(xb @ w, g, p), yb)

    w, losses = _fit(loss_fn, w0.to(dev), x, y, epochs=epochs, batch=batch,
                     lr=lr, seed=seed)

    def predict(xb):
        return torch.argmax(_group_logits(xb @ w, g, p), dim=-1)

    test_acc = -1.0
    if test_images is not None:
        test_acc = _accuracy(
            predict, torch.from_numpy(np.asarray(test_images,
                                                 np.float32)).to(dev),
            torch.from_numpy(np.asarray(test_labels, np.int64)))
    return TrainResult(
        model=_model(w, readout, t_steps, dev),
        train_acc=_accuracy(predict, x, y), test_acc=test_acc,
        steps=len(losses), wall_s=time.perf_counter() - t0, losses=losses)


def surrogate_logits(w: torch.Tensor, x: torch.Tensor, *, t_steps: int,
                     decay: float, threshold: float, beta: float,
                     g: int, p: int) -> torch.Tensor:
    """The surrogate trainer's forward: (B, n_in) images -> (B, G) scores.

    TTFS-encode in float into a frame raster (B, T, n_in); float LIF over T
    (``v = decay * v + i_t``); spike surrogate sigma(beta * (v - thr));
    readout per group = max over time and group of the soft spike trace
    weighted by (T - t) / T, so EARLIER spikes score higher."""
    tspike = torch.floor((1.0 - x) * (t_steps - 1))
    steps = torch.arange(t_steps, device=x.device)
    frames = (tspike[:, None, :] == steps[None, :, None]).to(torch.float32)
    frames = frames * (x > 0)[:, None, :]
    cur = torch.einsum("btn,no->bto", frames, w)
    v = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                    device=x.device)
    spikes = []
    for t in range(t_steps):
        v = decay * v + cur[:, t]
        spikes.append(torch.sigmoid(beta * (v - threshold)))
    s_t = torch.stack(spikes, dim=1)                         # (B, T, n_out)
    w_time = (t_steps - steps.to(torch.float32)) / t_steps
    score = torch.amax(s_t * w_time[None, :, None], dim=1)   # earlier => higher
    return torch.amax(score.reshape(-1, g, p), dim=-1)       # (B, G)


def train_surrogate(images: np.ndarray, labels: np.ndarray, *,
                    epochs: int = 2, batch: int = 128, lr: float = 2e-3,
                    seed: int = 0, t_steps: int = 16, tau: float = 16.0,
                    threshold: float = 1.0, beta: float = 5.0,
                    readout: snn.ReadoutSpec | None = None,
                    w_init: np.ndarray | None = None,
                    device: str | torch.device = "cuda") -> TrainResult:
    """Temporal surrogate-gradient training of the same topology (see
    ``surrogate_logits``). Without ``w_init`` the weights start normal with
    standard deviation 1/sqrt(n_in)."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    readout = readout or snn.ReadoutSpec()
    g, p = readout.n_groups, readout.per_group
    n_in, n_out = images.shape[1], g * p
    w0 = _initial_weight(
        n_in, n_out, seed, w_init,
        lambda gen: torch.randn(n_in, n_out, generator=gen) / np.sqrt(n_in))
    decay = float(np.exp(-1.0 / tau))
    x = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)

    def forward(w, xb):
        return surrogate_logits(w, xb, t_steps=t_steps, decay=decay,
                                threshold=threshold, beta=beta, g=g, p=p)

    def loss_fn(w, xb, yb):
        return _cross_entropy(forward(w, xb) * 8.0, yb)

    w, losses = _fit(loss_fn, w0.to(dev), x, y, epochs=epochs, batch=batch,
                     lr=lr, seed=seed)
    acc = _accuracy(lambda xb: torch.argmax(forward(w, xb), dim=-1),
                    x[:4096], y[:4096], chunk=4096)
    return TrainResult(model=_model(w, readout, t_steps, dev, tau=tau),
                       train_acc=acc, test_acc=-1.0, steps=len(losses),
                       wall_s=time.perf_counter() - t0, losses=losses)

"""SNN model construction as ``torch.nn`` modules (paper Table 2, left
column).

The port of ``repro.core.snn``: where the JAX package holds a params pytree
beside each module, these are ``nn.Module``s that own their parameters.

    SNN(Sequential(Linear(784, 150, generator=g), LIF(t_steps=32)),
        readout=ReadoutSpec(10, 15))

The deployed subset matches the paper: ``Linear`` (a dense synapse matrix,
no bias) + ``LIF`` (the integrate-and-fire stage, the identity in the
training graph). ``repro_torch.core.deploy.export`` turns an ``SNN`` into
the single deployment artifact.

``load_params`` carries the JAX package's params pytree
(``[{"w": ndarray}, {}]``, as numpy arrays) into a port ``SNN``, so both
packages can start from the same weights: ``jax.random`` bits cannot be
drawn in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.lowering import resolve_device


def float32_copy(w) -> torch.Tensor:
    """A float32 tensor copy of an array or a tensor (its device kept)."""
    if isinstance(w, torch.Tensor):
        return w.detach().to(torch.float32, copy=True)
    return torch.from_numpy(np.array(w, np.float32))


class Linear(nn.Module):
    """Dense synapse matrix: y = x @ w, ``w`` of shape (in, out) as in the
    JAX package. No bias — the deployed classifier carries weights and
    thresholds only (paper §2.2).

    With a ``generator`` the weights are drawn at construction
    (Kaiming-uniform, bound 1/sqrt(in), from the generator on the CPU, then
    moved to ``device``: the same generator state gives the same weights on
    every device); without one ``w`` is ``None`` until ``load_params`` or a
    trainer sets it, and ``deploy.export`` refuses the model."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.device = resolve_device(device)
        self.w: nn.Parameter | None = None
        if generator is not None:
            self.set_weight(self.init(generator))

    def init(self, generator: torch.Generator) -> torch.Tensor:
        """(in, out) float32 weights drawn from ``generator`` (a CPU one)."""
        bound = 1.0 / np.sqrt(self.in_features)
        w = torch.empty(self.in_features, self.out_features,
                        dtype=torch.float32)
        return w.uniform_(-bound, bound, generator=generator)

    def set_weight(self, w) -> None:
        """Install a copy of (in, out) weights (a tensor or an array) as the
        parameter."""
        w = float32_copy(w)
        if tuple(w.shape) != (self.in_features, self.out_features):
            raise ValueError(f"weights of shape {tuple(w.shape)} do not fit "
                             f"Linear({self.in_features}, "
                             f"{self.out_features})")
        self.w = nn.Parameter(w.to(self.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w is None:
            raise RuntimeError("Linear has no weights; draw them with a "
                               "generator or load_params")
        return x @ self.w


@dataclasses.dataclass
class LIFSpec:
    """LIF stage hyper-parameters (all deployment-artifact fields)."""
    threshold: float = 1.0          # float threshold used during training
    tau: float = 16.0               # leak time constant in steps (-> leak_shift)
    t_steps: int = 32               # simulation window T


class LIF(nn.Module):
    """Leaky integrate-and-fire stage. In the *training* graph it is the
    identity on synaptic currents (the TTFS decision rule is trained through
    the dense proxy); the deployed spiking dynamics live in the integer
    runtimes (reference.py / accelerator.py)."""

    def __init__(self, spec: LIFSpec | None = None, **kw):
        super().__init__()
        self.spec = spec or LIFSpec(**kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Sequential(nn.Sequential):
    """``nn.Sequential`` with the JAX package's ``layers`` list."""

    @property
    def layers(self) -> list[nn.Module]:
        return list(self)


@dataclasses.dataclass
class ReadoutSpec:
    """Grouped TTFS readout metadata (paper §2.3: 10 classes x 15 neurons)."""
    n_groups: int = 10
    per_group: int = 15
    fallback: str = "membrane"


class SNN(nn.Module):
    """Top-level model: a Sequential body + readout metadata. This is the
    object ``deploy.export`` consumes."""

    def __init__(self, body: Sequential, readout: ReadoutSpec | None = None,
                 encode_t: int = 32, x_min: float = 1.0 / 255.0):
        super().__init__()
        self.body = body
        self.readout = readout or ReadoutSpec()
        self.encode_t = encode_t
        self.x_min = x_min

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)

    # -- introspection used by deploy.export -------------------------------
    def linear_layers(self) -> Sequence[Linear]:
        return [layer for layer in self.body.layers
                if isinstance(layer, Linear)]

    def lif_layers(self) -> Sequence[LIF]:
        return [layer for layer in self.body.layers
                if isinstance(layer, LIF)]


def load_params(model: SNN, params: Sequence[dict[str, Any]]) -> SNN:
    """Carry the JAX package's params pytree into ``model``: ``params[i]``
    belongs to ``model.body.layers[i]`` (``{"w": (in, out) array}`` for a
    ``Linear``, ``{}`` for a ``LIF``). Returns ``model``."""
    layers = model.body.layers
    if len(params) != len(layers):
        raise ValueError(f"{len(params)} parameter entries for "
                         f"{len(layers)} layers")
    for layer, p in zip(layers, params):
        if isinstance(layer, Linear):
            layer.set_weight(p["w"])
        elif p:
            raise ValueError(f"{type(layer).__name__} takes no parameters, "
                             f"got {sorted(p)}")
    return model

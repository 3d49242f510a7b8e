"""Carry a JAX ``LM``'s parameters across into the port's ``LM``.

JAX keeps a parameter tree: ``embed``, ``final_norm`` (``final_norm_b``),
``lm_head`` (and an encoder-decoder's ``enc_final_norm``,
``enc_final_norm_b``) at the top, and the sublayers of one period stacked
over ``n_periods`` under ``blocks["{i}:{kind}"][name]``, each leaf of shape
(n_periods, ...). Slice p of each stacked leaf becomes
``lm.layers[p]["{i}:{kind}"][name]``, the cross-attention leaves ``x_*``
among them; an encoder's layers, stacked over ``enc_layers`` under
``enc_blocks["0:attn"][name]``, become ``lm.encoder[n]["0:attn"][name]``. Matrices keep JAX's ``x @ w``
orientation, (in, out), which is the port's too, so nothing is transposed.
Each leaf keeps its own dtype: a bf16 tree's router, ``A_log``, ``D`` and
``dt_bias`` are float32 in both packages, and a leaf whose dtype differs
from the port's is refused, never cast. The tree arrives as numpy arrays
(``jax.device_get`` or ``np.asarray`` on each leaf): the port imports
nothing of JAX.

``lm_to_jax`` carries them back: the port's ``LM`` -> JAX's tree of numpy
arrays, each stacked leaf read whole from ``lm.stacked``, whose slices
are the port's per-period parameters. ``leaf_groups`` names, for each leaf
of that tree, the leaf and the port's tensors that make it up: training
works on these groups, since JAX's optimisers and gradient compression
reduce over a whole stacked leaf (Adafactor factors a stacked norm scale
(n_periods, d) across its periods; its update clip and compression's scale
read all periods together).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import LM


def lm_from_jax(cfg: ArchConfig, params: dict, *,
                device: str | torch.device = "cuda") -> LM:
    """JAX ``LM.init_params`` tree of numpy arrays -> the port's ``LM`` on
    ``device``, in the tree's dtype (float32 or bfloat16; the embedding's).
    Raises on a missing, extra, misshapen or differently typed
    parameter."""
    lm = LM(cfg, dtype=_torch_dtype(np.asarray(params["embed"]).dtype),
            device=device)
    return load_jax(lm, params)


def load_jax(lm: LM, params: dict) -> LM:
    """Copy a JAX parameter tree of numpy arrays into ``lm`` in place (its
    parameters keep their device and dtype), each stacked leaf whole into
    ``lm.stacked``; the same checks as ``lm_from_jax``."""
    cfg = lm.cfg
    trees = {"blocks": {f"{i}:{kind}" for i, kind in enumerate(cfg.period)}}
    if cfg.enc_layers:
        trees["enc_blocks"] = {"0:attn"}
    for tree, keys in trees.items():
        if tree not in params or set(params[tree]) != keys:
            raise ValueError(f"expected {tree} of the period {sorted(keys)}; "
                             f"got {sorted(params.get(tree, ()))}")
        for key in keys:
            head = f"{tree}/{key}/"
            _load({path[len(head):]: t for path, t in lm.stacked.items()
                   if path.startswith(head)}, params[tree][key],
                  f"{tree}[{key!r}]")
    _load(lm.top, {k: v for k, v in params.items() if k not in trees},
          "params")
    return lm


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    if dt == np.float32:
        return torch.float32
    if dt.name == "bfloat16":          # ml_dtypes' bfloat16, as JAX hands it
        return torch.bfloat16
    raise TypeError(f"unsupported parameter dtype {dt}")


@torch.no_grad()
def _load(dest, src: dict, where: str) -> None:
    if set(dest) != set(src):
        raise ValueError(f"{where}: the port has {sorted(dest)}, the JAX "
                         f"tree {sorted(src)}")
    for name, arr in src.items():
        arr = np.asarray(arr)
        w = dest[name]
        if tuple(arr.shape) != tuple(w.shape):
            raise ValueError(f"{where}[{name!r}]: shape {arr.shape}, the port "
                             f"expects {tuple(w.shape)}")
        if _torch_dtype(arr.dtype) != w.dtype:
            raise TypeError(f"{where}[{name!r}]: dtype {arr.dtype}, the port "
                            f"holds {w.dtype}")
        if arr.dtype.name == "bfloat16":
            # numpy has no bfloat16: move its bits, then reinterpret
            t = torch.from_numpy(np.array(arr).view(np.int16))
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        w.copy_(t)


class LeafGroup(NamedTuple):
    """One leaf of JAX's parameter tree: its ``"/"``-joined path, the leaf
    in JAX's shape (a stacked leaf's tensor ``lm.stacked[path]``, which
    holds its periods' parameters; a top-level parameter itself), and the
    port's parameters that make it up (one a period, in order, or the one
    top-level parameter). Writing into ``leaf`` writes the parameters."""
    path: str
    leaf: torch.Tensor
    tensors: list[torch.Tensor]

    @property
    def stacked(self) -> bool:
        return self.leaf is not self.tensors[0]

    @property
    def views(self) -> bool:
        """Whether every parameter shares the leaf's storage, so that
        writing into either writes the other. The model's own are views; a
        ``DTensor``'s select on a period dim sharded over the data axes
        gathers the period into a copy."""
        def storage(t):
            return getattr(t, "_local_tensor", t).untyped_storage()
        base = storage(self.leaf)
        return all(storage(t) is base for t in self.tensors)

    def stack(self, tensors) -> torch.Tensor:
        """Tensors paired with ``tensors`` (such as their gradients) in the
        leaf's shape: stacked over the periods, or the one tensor."""
        return torch.stack(list(tensors)) if self.stacked else tensors[0]


def leaf_groups(lm: LM) -> list[LeafGroup]:
    """Every leaf of ``lm``'s JAX tree in JAX's flatten order (dict keys
    sorted at each level): ``embed``, ``final_norm``... one tensor each;
    ``blocks/{i}:{kind}/{name}`` the tensors of its sublayer in every period;
    ``enc_blocks/0:attn/{name}`` those of every encoder layer."""
    groups = {name: LeafGroup(name, t, [t]) for name, t in lm.top.items()}
    for path, leaf in lm.stacked.items():
        tree, key, name = path.split("/")
        blocks = lm.layers if tree == "blocks" else lm.encoder
        groups[path] = LeafGroup(path, leaf, [blk[key][name]
                                              for blk in blocks])
    return [groups[k] for k in sorted(groups, key=lambda k: k.split("/"))]


def nest(flat: dict) -> dict:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    out: dict = {}
    for path, x in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = x
    return out


@torch.no_grad()
def lm_to_jax(lm: LM) -> dict:
    """The port's ``LM`` -> JAX's ``init_params`` tree of numpy arrays on
    the host, the inverse of ``lm_from_jax``: float32 leaves as float32,
    bfloat16 ones as their bits viewed as ml_dtypes' bfloat16 (numpy has
    no bfloat16 of its own; that package is imported only for a bfloat16
    model)."""
    return nest({g.path: _numpy(g.leaf) for g in leaf_groups(lm)})


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    import ml_dtypes               # a bfloat16 model only
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


"""Divisibility-aware sharding resolver: the port of
``repro.distributed.sharding`` (MaxText-style logical rules with explicit
fallback chains, so every configuration of the registry shards cleanly).

Why fallbacks are load-bearing:
  * GQA KV heads are 4/6/8 across the pool — none divide the 16-way model
    axis. Fallback: shard head_dim (128/16=8) instead.
  * qwen2.5-32b has 40 query heads (!%16). Same fallback.
  * whisper vocab 51865 and internvl2 vocab 92553 are not 16-divisible:
    embedding/logits fall back to replicated vocab + data-sharded d_model.
  * Mixtral has 8 experts (!%16): expert FFN shards d_ff_expert instead.

Parameters use TP("model") x FSDP(data axes): one dim on "model", a second
dim on ("pod","data") — ZeRO-3 semantics. Stacked-layer leading dims are
never sharded unless ``fsdp_mode="stack"`` asks for it.

Every rule is a pure function of a mesh's axis names and sizes. A mesh is
anything with ``axis_names`` (a tuple) and ``shape`` (a dict of sizes by
name), ``Mesh`` below or JAX's tests' ``MockMesh``, or a ``DeviceMesh``,
which every rule reads through ``mesh_of``. A rule's answer is a ``Spec``: a tuple of ``None``, an
axis name, or a tuple of axis names, one per tensor dim, so that
``tuple(spec) == tuple(jax_spec)`` compares it with JAX's
``PartitionSpec``. ``to_placements`` turns a spec into the DTensor
placements of a ``DeviceMesh``.

Trees are nested dicts whose leaves carry a ``shape`` (tensors, meta tensors
among them) or are Python numbers (an optimiser's ``step``, a cache's
``len``: scalars). A leaf's path is its keys joined by ``"/"``, so a flat
dict keyed by JAX's paths (``models.convert.leaf_groups``) and the nested
tree JAX holds give the same paths: ``"blocks/0:attn/wq"``,
``"m/blocks/0:attn/wq"``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any


class Spec(tuple):
    """A partition spec: one entry per tensor dim, ``None`` (replicated),
    a mesh axis name, or a tuple of axis names (major to minor)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh's axis names and sizes, all the rules read."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_of(mesh) -> Any:
    """The names and sizes of a ``DeviceMesh`` as a ``Mesh``; any other
    mesh (a ``Mesh``, a mock with ``axis_names`` and ``shape``) as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return mesh
    return Mesh(tuple(names), tuple(mesh.size(i) for i in range(mesh.ndim)))


# --------------------------------------------------------------- helpers
def dp_axes(mesh) -> tuple[str, ...]:
    mesh = mesh_of(mesh)
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    mesh = mesh_of(mesh)
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def _fits(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


def resolve_axis(mesh, dim: int, logical):
    """logical: None | 'model' | 'data' | tuple of fallback candidates.
    'data' means the full data-parallel prefix (pod+data)."""
    if logical is None:
        return None
    mesh = mesh_of(mesh)
    candidates = logical if isinstance(logical, tuple) else (logical,)
    for cand in candidates:
        if cand is None:
            return None
        mesh_axes = dp_axes(mesh) if cand == "data" else (cand,)
        mesh_axes = tuple(a for a in mesh_axes if a in mesh.axis_names)
        if not mesh_axes:
            continue
        if _fits(dim, mesh, mesh_axes):
            return mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]
    return None


def spec(mesh, shape, logical_axes) -> Spec:
    """A spec with per-dim divisibility fallback, no mesh axis used
    twice."""
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    mesh = mesh_of(mesh)
    used: set[str] = set()
    out = []
    for dim, logical in zip(shape, logical_axes):
        r = resolve_axis(mesh, dim, logical)
        flat = (r,) if isinstance(r, str) else (r or ())
        if r is not None and not (set(flat) & used):
            out.append(r)
            used.update(flat)
        else:
            out.append(None)
    return Spec(*out)


def to_placements(mesh, s) -> list:
    """The DTensor placements of spec ``s`` on ``mesh`` (a ``DeviceMesh``
    or a mesh record), one per mesh dim: ``Shard(i)`` on each mesh dim that
    tensor dim i names, ``Replicate()`` on the others. A dim on ("pod",
    "data") is sharded on both, pod major, as JAX lays it out; DTensor
    shards in mesh-dim order, so the axes of one dim must name mesh dims in
    that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh_of(mesh).axis_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(s):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {s}: dim {i} names {axes}, not in the "
                             f"mesh's order {names}")
        for j in order:
            out[j] = Shard(i)
    return out


def make_constrainer(mesh):
    """The callback models take: ``constrain(x, logical_axes)``, JAX's
    ``with_sharding_constraint`` through these rules. A ``DTensor`` comes
    back redistributed to ``to_placements(mesh, spec(mesh, x.shape,
    logical_axes))`` (the collectives that takes are DTensor's); anything
    else, a plain tensor on one card among it, comes back as the same
    object. The callback carries the mesh (``constrain.mesh``, a
    ``DeviceMesh``) so that expert-parallel layers bind to it without
    models building meshes."""
    from torch.distributed.tensor import DTensor

    def constrain(x, logical_axes):
        if not isinstance(x, DTensor):
            return x
        s = spec(mesh, tuple(x.shape), tuple(logical_axes))
        return x.redistribute(mesh, to_placements(mesh, s))
    constrain.mesh = mesh
    return constrain


# ------------------------------------------------- parameter sharding rules
# Suffix-matched rules: (regex on the flattened path) -> logical axes for the
# TRAILING dims (leading stack dims are replicated automatically).
_PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings / head
    (r"embed$",         (("model", None), "data")),
    (r"lm_head$",       ("data", ("model", None))),
    # attention projections (d, F) / (F, d)
    (r"(wq|wk|wv|x_wq|x_wk|x_wv)$", ("data", ("model", None))),
    (r"(wo|x_wo)$",     (("model", None), "data")),
    # dense FFN
    (r"(w_gate|w_up|w_in)$",  ("data", ("model", None))),
    (r"(w_down|w_out)$",      (("model", None), "data")),
    # MoE experts (E, d, f) / (E, f, d) — E first, fall back to f
    (r"experts.*",      ()),   # placeholder, handled dimension-wise below
    (r"router$",        ("data", None)),
    # mamba
    (r"in_proj$",       ("data", ("model", None))),
    (r"out_proj$",      (("model", None), "data")),
    (r"conv_w$",        (None, ("model", None))),
    # biases / norms / scalars -> replicated
]


def _param_logical(path: str, shape) -> tuple:
    nd = len(shape)
    base = None
    for pat, rule in _PARAM_RULES:
        if re.search(pat, path):
            base = rule
            break
    # MoE expert tensors are 4D: (n_periods, E, d, f). The ndim>=4 guard is
    # load-bearing: dense stacked FFN weights are 3D (L, d, f), and treating
    # L as an expert dim would shard the layer stack over "model".
    if re.search(r"(w_gate|w_up|w_down)$", path) and nd >= 4 \
            and "blocks" in path:
        # (..., E, a, b): prefer E on model; fallback to the wide dim
        if re.search(r"w_down$", path):
            tail = (("model", None), ("model", None), "data")
        else:
            tail = (("model", None), "data", ("model", None))
        lead = (None,) * (nd - 3)
        return lead + tail
    if base is None or len(base) == 0:
        if nd >= 2:
            base = ("data", ("model", None))     # generic (in, out)
        else:
            return (None,) * nd
    lead = (None,) * (nd - len(base))
    return lead + tuple(base)


def path_str(path) -> str:
    """A leaf's path, its keys joined by "/"."""
    return "/".join(str(p) for p in path)


def _ndim(leaf) -> int:
    return len(leaf.shape) if hasattr(leaf, "shape") else 0


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts, its structure kept."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _strip_data(logical) -> tuple:
    """Remove FSDP ('data') requests from a logical-axes tuple (TP-only)."""
    out = []
    for lg in logical:
        if lg == "data":
            out.append(None)
        elif isinstance(lg, tuple):
            kept = tuple(x for x in lg if x != "data")
            out.append(kept if kept else None)
        else:
            out.append(lg)
    return tuple(out)


def param_pspecs(mesh, params_tree, *, fsdp: bool = True,
                 fsdp_mode: str = "hidden") -> Any:
    """The spec tree of a parameter or optimiser-state tree.

    fsdp=True, fsdp_mode="hidden" (baseline): TP("model") x ZeRO-3 on a
    hidden weight dim.

    fsdp_mode="stack": shard the layer-STACK dim (axis 0 of blocks/*) over
    the data axes instead, where the stack divides them; else the hidden
    dim as in the baseline (9 Jamba periods).

    fsdp=False ('tp_only'): weights shard on "model" only — valid whenever
    params + optimizer state fit per-card memory (tp_only_fits decides)."""
    mesh = mesh_of(mesh)

    def per(path, leaf):
        p = path_str(path)
        nd = _ndim(leaf)
        if nd == 0:
            return Spec()
        logical = _param_logical(p, leaf.shape)
        if not fsdp:
            logical = _strip_data(logical)
        elif fsdp_mode == "stack" and "blocks" in p and nd >= 3:
            stack = leaf.shape[0]
            logical = ("data",) + _strip_data(logical)[1:]
            if resolve_axis(mesh, stack, "data") is None:
                logical = _param_logical(p, leaf.shape)
        return spec(mesh, leaf.shape, logical)
    return _map(per, params_tree)


def tp_only_fits(cfg, mesh, hbm_bytes: int, frac: float = 0.35) -> bool:
    """Do TP-only params + optimizer state fit the memory budget? If yes,
    FSDP's collective cost buys nothing."""
    model_ways = axis_size(mesh_of(mesh), ("model",))
    p_bytes = 2.0 * cfg.param_count() / model_ways             # bf16
    opt_mult = {"adamw": 4.0, "adafactor": 0.1, "sgd": 2.0}[cfg.optimizer]
    state = opt_mult * 2.0 * cfg.param_count() / model_ways
    return (p_bytes + state) <= frac * hbm_bytes


# ------------------------------------------------------------ cache/batch
def batch_pspec(mesh, batch_tree) -> Any:
    """Each leaf's batch dim (its first) on the data axes where they divide
    it, the other dims replicated."""
    mesh = mesh_of(mesh)

    def per(path, leaf):
        nd = _ndim(leaf)
        if nd == 0:
            return Spec()
        ax = resolve_axis(mesh, leaf.shape[0], "data")
        return Spec(ax, *([None] * (nd - 1)))
    return _map(per, batch_tree)


def cache_pspecs(mesh, cache_tree, *, seq_shard: bool = False) -> Any:
    """KV/SSM cache sharding. Layout: attn k/v (periods, B, Hkv, S, D);
    mamba state (periods, B, H, N, P), conv (periods, B, K-1, ch).
    Preference: batch on data; heads on model (fallback head_dim/state-dim);
    if batch can't shard (B=1 long-context), shard the sequence dim on data.

    seq_shard=True (the "flash-decode" variant): shard the cache SEQUENCE
    dim on "model" instead of head_dim."""
    mesh = mesh_of(mesh)

    def per(path, leaf):
        p = path_str(path)
        if _ndim(leaf) == 0:
            return Spec()
        if p.endswith("len"):
            return Spec()
        if "state" in p:   # (periods, B, H, N, Pdim)
            return spec(mesh, leaf.shape,
                        (None, "data", ("model", None), None, None))
        if "conv" in p:    # (periods, B, K-1, ch)
            return spec(mesh, leaf.shape,
                        (None, "data", None, ("model", None)))
        # attention caches (periods, B, Hkv, S, D)
        b = leaf.shape[1]
        if seq_shard:
            batch_ax = "data" if resolve_axis(mesh, b, "data") else None
            return spec(mesh, leaf.shape,
                        (None, batch_ax, None, ("model", None), None))
        if resolve_axis(mesh, b, "data") is not None:
            return spec(mesh, leaf.shape,
                        (None, "data", ("model", None), None,
                         (None if _fits(leaf.shape[2], mesh, ("model",))
                          else "model")))
        # B=1: sequence-shard the cache on the data axes
        return spec(mesh, leaf.shape,
                    (None, None, ("model", None), "data",
                     (None if _fits(leaf.shape[2], mesh, ("model",))
                      else "model")))
    return _map(per, cache_tree)


def flatten(tree, path=()) -> dict[str, Any]:
    """A tree's leaves by path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, path + (k,)))
        return out
    return {path_str(path): tree}


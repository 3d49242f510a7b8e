"""Mixture-of-Experts FFN with capacity-based dispatch.

The port of ``repro.models.moe`` (``capacity``, ``moe_ffn``,
``moe_ffn_dense_oracle``), step for step:

  * routing in float32: a softmax over all E experts of
    ``x.float() @ router.float()``, the top k renormalised, and the Switch
    load-balance aux ``E * sum(mean(probs) * mean(onehot(top-1)))``;
  * no (tokens, E, C) one-hot dispatch tensor: per batch row the
    assignments, flattened token-major then k, get a position in their
    expert's buffer from a cumsum over a (S*k, E) one-hot; ``keep = pos < C``
    and dropped assignments add exactly zero;
  * a (B, E, C, d) buffer in ``x.dtype``, filled by a scatter-add, SwiGLU
    experts as batched products over E, and the combine weight cast to
    ``x.dtype`` before the multiply, summed over k.

``jax.lax.top_k`` takes the lowest index first among equal values and
``torch.topk`` does not, so the top k come from a stable descending sort.
The expert products are ``torch.matmul``, as JAX leaves its einsums to XLA;
no kernel of this package runs here.

``moe_ffn`` and ``route`` each open a device span (``telemetry.trace``),
``moe_ffn`` and ``moe.route``; ``moe_ffn`` counts the expert-buffer rows
it computes (``moe_ffn.slots``, E * B * C) and the assignments it kept
(``moe_ffn.kept``, summed on the device when the counts are read).

``moe_ffn_shard_map`` is JAX's expert-parallel form over a
``torch.distributed`` ``DeviceMesh`` with a "model" dim: each model rank
runs E / model of the experts on its data shard's rows and one all-reduce
over "model" merges their outputs. ``LM`` takes it where
``cfg.moe_buf_mode == "shard_map"``, its ``constrain`` carries such a mesh
and the model dim divides E; elsewhere ``moe_ffn`` (whose ``buf_mode``
steers only JAX's sharding).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.telemetry import trace

Constrain = Callable[[torch.Tensor, tuple], torch.Tensor]


def capacity(S: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(S * top_k / n_experts * factor))
    return max(8, ((c + 7) // 8) * 8)   # sublane-align, as JAX does


def topk(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lowest index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """What ``moe_ffn`` decides before it touches an expert."""
    top_w: torch.Tensor     # (B, S, k) renormalised float32 weights
    top_i: torch.Tensor     # (B, S, k) expert ids, int64
    pos: torch.Tensor       # (B, S*k) int32 position in the expert's buffer
    keep: torch.Tensor      # (B, S*k) pos < C
    aux: torch.Tensor       # float32 scalar, the Switch load-balance loss
    capacity: int           # C


def _probs(x: torch.Tensor, router: torch.Tensor,
           psum: Callable | None = None) -> torch.Tensor:
    """The router's softmax over the E experts (B, S, E), float32; ``psum``
    sums the logits where each rank holds a shard of d (``local_experts``)."""
    logits = x.float() @ router.float()
    return torch.softmax(logits if psum is None else psum(logits), dim=-1)


def balance(probs: torch.Tensor, top_i: torch.Tensor,
            n_experts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The Switch load-balance loss's two means over the tokens of probs
    (B, S, E): each expert's mean router probability and its share of the
    first choices, (E,) each."""
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(top_i[..., 0], n_experts).float().mean(dim=(0, 1))
    return me, ce


def balance_loss(me: torch.Tensor, ce: torch.Tensor) -> torch.Tensor:
    """The load-balance loss from ``balance``'s means: E * sum(me * ce)."""
    return me.shape[0] * torch.sum(me * ce)


def route(x: torch.Tensor, router: torch.Tensor, *, n_experts: int,
          top_k: int, capacity_factor: float = 1.0,
          constrain: Constrain | None = None,
          psum: Callable | None = None) -> Routing:
    """``moe_ffn``'s routing and dispatch coordinates on x (B, S, d);
    ``constrain`` takes the one-hot in JAX's (B, S*k, E) layout, ``psum``
    the router's logits (``_probs``)."""
    with trace.device_span("moe.route"):
        B, S, _ = x.shape
        E, k = n_experts, top_k
        C = capacity(S, k, E, capacity_factor)
        probs = _probs(x, router, psum)
        top_w, top_i = topk(probs, k)
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        aux = balance_loss(*balance(probs, top_i, E))
        flat_e = top_i.reshape(B, S * k)
        # JAX's sum((cumsum(onehot) - 1) * onehot, -1), as (cumsum - 1) read
        # at each assignment's own expert; the one-hot is laid out (B, E,
        # S*k) so that the cumsum runs along its innermost axis (a scan
        # along the outer one took 12.9 ms a Qwen3-MoE layer on an H100)
        experts = torch.arange(E, device=x.device)[None, :, None]
        onehot = (flat_e[:, None, :] == experts).to(torch.int32)  # (B, E, S*k)
        if constrain is not None:
            onehot = constrain(onehot.transpose(1, 2),
                               ("data", None, "model")).transpose(1, 2)
        counts = onehot.cumsum(dim=2, dtype=torch.int32)
        pos = counts.gather(1, flat_e[:, None, :])[:, 0] - 1
        return Routing(top_w, top_i, pos, pos < C, aux, C)


def moe_ffn(x: torch.Tensor, p, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.0, constrain: Constrain | None = None,
            buf_mode: str = "e_sharded"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d); p: router (d, E), w_gate/w_up (E, d, f), w_down (E, f, d)
    -> (out (B, S, d), aux float32 scalar). ``constrain`` is JAX's
    callback, handed the one-hot, the buffer (twice: fresh, then filled)
    and the experts' activations h and y at JAX's points and in JAX's
    layouts, (B, S*k, E) and (B, E, C, .), each a view of the port's own
    E-major layout (the transposes there and back copy nothing);
    ``buf_mode`` picks the buffer's logical axes, JAX's ("data", None,
    None, None) under "local", ("data", "model", None, None) otherwise.
    Neither changes a result. The calls keep JAX's sequence of constraints,
    but no constraint here ever acts: on one card the tensors are plain,
    and the dry-run runs this function inside its ``moe_ffn`` region on
    each rank's plain shards (``launch/dryrun.py``), whose placements
    stand in for these constraints; so ``buf_mode`` has no effect there
    either (``dryrun.no_effect``)."""
    with trace.device_span("moe_ffn"):
        constrain = constrain or (lambda t, axes: t)
        B, S, d = x.shape
        E, k = n_experts, top_k
        r = route(x, p["router"], n_experts=E, top_k=k,
                  capacity_factor=capacity_factor, constrain=constrain)
        C = r.capacity
        trace.device_count("moe_ffn.slots", E * B * C)
        trace.device_count("moe_ffn.kept", r.keep)
        flat_e = r.top_i.reshape(B, S * k)
        pos_c = r.pos.clamp(max=C - 1)

        def jax_layout(t, axes):
            """``constrain`` on the (E, B*C, .) tensor t seen as JAX's
            (B, E, C, .), returned in t's layout."""
            v = t.view(E, B, C, t.shape[-1]).transpose(0, 1)
            return constrain(v, axes).transpose(0, 1).reshape(t.shape)

        # ---- dispatch: scatter-add the kept assignments into (E, B, C, d)
        xk = x.repeat_interleave(k, dim=1)                       # (B, S*k, d)
        vals = xk.masked_fill_(~r.keep[..., None], 0)
        b_idx = torch.arange(B, device=x.device)[:, None]
        slot = (flat_e * B + b_idx) * C + pos_c                  # (B, S*k)
        buf_axes = ("data", None, None, None) if buf_mode == "local" \
            else ("data", "model", None, None)
        buf = jax_layout(x.new_zeros((E, B * C, d)), buf_axes)
        buf = buf.view(E * B * C, d).index_add_(0, slot.reshape(-1),
                                                vals.reshape(-1, d))
        buf = jax_layout(buf.view(E, B * C, d), buf_axes)

        # ---- experts (SwiGLU), one batched product over E
        act = ("data", "model", None, None)
        h = torch.matmul(buf, p["w_gate"])
        u = torch.matmul(buf, p["w_up"])
        h = jax_layout(F.silu(h) * u, act)
        y = jax_layout(torch.matmul(h, p["w_down"]), act)        # (E, B*C, d)

        # ---- combine
        out_k = y.view(E * B * C, d)[slot.reshape(-1)].view(B, S * k, d)
        out_k = out_k.masked_fill_(~r.keep[..., None], 0)
        out_k = out_k * r.top_w.reshape(B, S * k)[..., None].to(x.dtype)
        out = out_k.view(B, S, k, d).sum(dim=2)
        return out, r.aux.float()


class _SumGrad(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``groups`` (one
    after another) in the backward: a replicated input's cotangent summed
    over the mesh dims it is replicated on, as JAX's shard_map transpose
    sums it."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class _AllReduce(torch.autograd.Function):
    """All-reduce over ``group`` forward, identity backward: every rank's
    partial output takes the whole output's gradient (JAX divides the
    cotangent of an output replicated over "model" by the model size and
    psums it back)."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FirstShard(torch.autograd.Function):
    """JAX's ``out_specs=P()`` under ``check_rep=False`` for a value that
    differs across data shards: the forward returns data rank 0's value on
    every rank (a sum over the data groups in which only data rank 0 adds a
    non-zero), and the backward gives this rank's value ``1 / size`` of the
    cotangent, ``size`` the mesh's number of ranks."""

    @staticmethod
    def forward(ctx, v, first, groups, size):
        ctx.size = size
        v = v.clone() if first else torch.zeros_like(v)
        for group in groups:
            dist.all_reduce(v, group=group)
        return v

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None, None, None


def moe_ffn_shard_map(x: torch.Tensor, p, *, n_experts: int, top_k: int,
                      capacity_factor: float, mesh,
                      model_axis: str = "model"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over ``mesh``, a ``DeviceMesh`` with a
    ``model_axis`` dim (data dims "pod" and "data" where it has them): the
    port of JAX's shard_map form, run on every rank of the mesh.

      * x (B_l, S, d) is this rank's rows: its data shard, the same on
        every rank of its model group; p holds all E experts, and the rank
        reads the views of its own E_loc = E / model (``w_gate``, ``w_up``,
        ``w_down`` rows ``rank * E_loc`` on) and no other expert;
      * routing is ``route``'s, on all E experts (the float32 router, the
        stable-sort top k, ``pos`` from a cumsum over all E, C from S), so
        every model rank drops the assignments ``moe_ffn`` drops;
      * the dispatch scatter and the combine gather are local, masked to
        the rank's own experts (foreign assignments land on local expert 0
        and add exact zeros);
      * one all-reduce of the (B_l, S, d) partial output over the model
        group is the only collective on the output.

    Returns (out (B_l, S, d), aux float32 scalar) on every rank. At a model
    dim of size 1 this is ``moe_ffn`` op for op, and its output is.

    Gradients are those of ``jax.grad`` through JAX's shard_map: the
    output's all-reduce has an identity backward, and the gradients of the
    replicated inputs are all-reduced over the dims they are replicated on
    (x over "model", the router over every dim, each expert slice over the
    data dims), so each rank ends with JAX's gradient of its own shard.

    ``aux`` reproduces two faults of the reference (ROADMAP §3): JAX
    returns it under ``out_specs=P()`` with ``check_rep=False``, so (1) the
    forward's aux is the first data shard's (data rank 0's, here sent to
    every rank), not the batch's, and (2) its gradient is that of the mean
    over data shards of each shard's aux: each rank's own aux takes 1 /
    (mesh size) of the cotangent before the sums above.

    x must lie on the mesh's device type; a "cuda" mesh without a card
    raises."""
    if mesh.device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a 'cuda' mesh was passed but CUDA is not available; build the "
            "mesh with device_type='cpu' to run on the CPU")
    if x.device.type != mesh.device_type:
        raise ValueError(f"x lies on {x.device}, the mesh on "
                         f"{mesh.device_type!r}")
    names = tuple(mesh.mesh_dim_names)
    B, S, d = x.shape
    E, k = n_experts, top_k
    msize = mesh.size(names.index(model_axis))
    if E % msize:
        raise ValueError(f"{E} experts do not divide over a {model_axis} "
                         f"dim of {msize}")
    E_loc = E // msize
    lo = mesh.get_local_rank(model_axis) * E_loc
    return shard_map_body(x, p["router"],
                          *(p[name][lo:lo + E_loc]
                            for name in ("w_gate", "w_up", "w_down")),
                          n_experts=E, top_k=k,
                          capacity_factor=capacity_factor, mesh=mesh,
                          model_axis=model_axis)


def shard_map_body(x: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
                   wu: torch.Tensor, wd: torch.Tensor, *, n_experts: int,
                   top_k: int, capacity_factor: float, mesh,
                   model_axis: str = "model"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn_shard_map`` on this rank's shards as its shard_map body
    receives them: x (B_l, S, d) its rows, the whole float32 router, and
    w_gate, w_up, w_down its E / model experts. The dry-run calls it on a
    DTensor's local shards."""
    names = tuple(mesh.mesh_dim_names)
    E_loc = wg.shape[0]
    rank = mesh.get_local_rank(model_axis)
    dp = [a for a in ("pod", "data") if a in names]
    model_group = mesh.get_group(model_axis)
    dp_groups = [mesh.get_group(a) for a in dp]

    x = _SumGrad.apply(x, [model_group])
    router = _SumGrad.apply(router, [mesh.get_group(a) for a in names])
    wg, wu, wd = (_SumGrad.apply(w, dp_groups) for w in (wg, wu, wd))
    out, r = local_experts(x, router, wg, wu, wd, rank * E_loc,
                           n_experts=n_experts, top_k=top_k,
                           capacity_factor=capacity_factor)
    out = _AllReduce.apply(out, model_group)
    first = all(mesh.get_local_rank(a) == 0 for a in dp)
    aux = _FirstShard.apply(r.aux.float(), first, dp_groups, mesh.size())
    return out, aux


def local_experts(x: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
                  wu: torch.Tensor, wd: torch.Tensor, lo: int, *,
                  n_experts: int, top_k: int, capacity_factor: float,
                  psum: Callable | None = None
                  ) -> tuple[torch.Tensor, Routing]:
    """Experts ``lo`` .. ``lo + E_loc`` of all E on x (B, S, d), E_loc =
    ``wg.shape[0]``: ``route``'s routing over all E with the whole
    router, then the dispatch scatter, the experts and the combine gather,
    local and masked to these experts (foreign assignments land on local
    expert 0 and add exact zeros) -> (this part of the output, the
    routing). The parts summed over a partition of the experts are
    ``moe_ffn``'s output. Where x, the router and the experts hold one
    shard of d each (the dry-run's decode step), ``psum`` sums the
    products over d (the router's logits, the gate and up activations)
    across the ranks that hold the other shards, and the output is this
    shard of d."""
    B, S, d = x.shape
    k, E_loc = top_k, wg.shape[0]
    psum = psum or (lambda t: t)
    r = route(x, router, n_experts=n_experts, top_k=k,
              capacity_factor=capacity_factor, psum=psum)
    C = r.capacity
    flat_e = r.top_i.reshape(B, S * k)
    mine = (flat_e >= lo) & (flat_e < lo + E_loc)
    e_loc = torch.where(mine, flat_e - lo, 0)
    use = r.keep & mine
    pos_c = r.pos.clamp(max=C - 1)

    # ---- dispatch: scatter-add these kept assignments, (E_loc, B, C, d)
    xk = x.repeat_interleave(k, dim=1)                           # (B, S*k, d)
    vals = xk.masked_fill_(~use[..., None], 0)
    b_idx = torch.arange(B, device=x.device)[:, None]
    slot = (e_loc * B + b_idx) * C + pos_c                       # (B, S*k)
    buf = torch.zeros((E_loc * B * C, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot.reshape(-1), vals.reshape(-1, d))

    # ---- these experts (SwiGLU), one batched product over E_loc
    buf = buf.view(E_loc, B * C, d)
    h = psum(torch.matmul(buf, wg))
    u = psum(torch.matmul(buf, wu))
    y = torch.matmul(F.silu(h) * u, wd)                          # (E_loc, B*C, d)

    # ---- combine, local
    out_k = y.view(E_loc * B * C, d)[slot.reshape(-1)].view(B, S * k, d)
    out_k = out_k.masked_fill_(~use[..., None], 0)
    out_k = out_k * r.top_w.reshape(B, S * k)[..., None].to(x.dtype)
    return out_k.view(B, S, k, d).sum(dim=2), r


def moe_ffn_dense_oracle(x: torch.Tensor, p, *, n_experts: int,
                         top_k: int) -> torch.Tensor:
    """Every expert on every token, the top k combined: no capacity, no
    drops. ``moe_ffn`` equals it wherever nothing drops."""
    probs = _probs(x, p["router"])
    top_w, top_i = topk(probs, top_k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    mask = F.one_hot(top_i, n_experts).float()                   # (B, S, k, E)
    w_e = torch.einsum("bske,bsk->bse", mask, top_w).to(x.dtype)  # (B, S, E)
    # JAX's einsum over e, one expert at a time (no (B, E, S, f) tensor):
    # the sum over e is kept in float32 and rounded to x's dtype once
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(n_experts):
        y = (F.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])) @ p["w_down"][e]
        out += y.float() * w_e[..., e, None].float()
    return out.to(x.dtype)

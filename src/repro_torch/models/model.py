"""The LM zoo's model: one forward / prefill / decode over every family the
port runs.

The port of ``repro.models.model.LM``. A model is ``cfg.n_periods`` periods
of the sublayers of ``cfg.period`` (dense, MoE, Whisper's decoder and
InternVL: one ``"attn"``; Mamba2: one ``"mamba"``; Jamba: one attention and
seven mamba sublayers). Each sublayer holds attention or mamba parameters,
plus a MoE FFN where ``cfg.is_moe_layer(i)``, else the dense FFN where
``d_ff`` is set. ``LM`` is an ``nn.Module`` holding them under JAX's names:
``layers[p]`` is period p, an ``nn.ModuleDict`` of one ``nn.ParameterDict``
per sublayer, keyed ``"{i}:{kind}"`` as JAX's ``blocks`` are (JAX stacks
them over ``n_periods``). An encoder-decoder (Whisper, ``cfg.enc_layers``)
also holds the cross-attention leaves ``x_*`` in each decoder sublayer and
``encoder[n]["0:attn"]`` for each of its encoder layers (JAX's
``enc_blocks``). Each sublayer's parameters are slices of one tensor per
JAX leaf, stacked over the periods (or encoder layers) as JAX stacks it:
``lm.stacked["blocks/{i}:{kind}/{name}"]`` (``"enc_blocks/0:attn/..."``)
is that leaf in JAX's shape, sharing storage with its slices, so training
updates a whole leaf in place and nothing restacks it. The model is
never moved or cast after it is built (``.to`` would part the slices from
their leaf). Weight matrices keep JAX's ``x @ w`` orientation, (in, out),
so a JAX parameter tree loads without a transpose (``models/convert.py``).
The router, ``A_log``, ``D`` and ``dt_bias`` are float32 whatever the
model's dtype, as JAX draws them. What ``attn_gqa_mode`` steers (the
GQA layout under XLA) has no counterpart here and changes no result.
``constrain`` is JAX's callback (``distributed.sharding.make_constrainer``),
called at JAX's points in JAX's order: x after the embedding and the
logits (always), each sublayer's weights under ``cfg.fsdp_weight_gather``
(``_gather_weights``), and, under ``cfg.activation_constraints``
(``constrain_mid``), q and k, the dense FFN's input, the MoE sublayer's
one-hot, buffer and expert activations and the SSD's chunked inputs. On a
``DTensor`` it redistributes as JAX's sharding constraint does; on a plain
tensor it returns the same object, so one card computes the same bits with
or without it. The MoE and SSD calls never meet a ``DTensor``: the dry-run
runs those functions in regions on each rank's plain shards
(``launch/dryrun.py``), whose placements stand in for them. It also
carries the mesh, ``constrain.mesh``. ``_lookup``, ``_nll``, ``_store``,
``_split_heads``, ``_merge_heads``, ``_norm``, ``_qk_norm``, ``_proj``,
``_out``, ``_residual``, ``_carry``, ``_gather_weights`` and
``decode_step`` are the points where the dry-run's regions step in for
DTensor (the sharded lookup, log-sum-exp, cache write, head split and
merge, a norm and its gradient, q's and k's norm scale, a column- and a
row-parallel product on the weight's stored shard, the residual add of a
row-parallel product, the residual stream as a period takes it, the
weights gathered at use, the decode step's policy); on plain tensors they
are the model's own arithmetic. With
``cfg.moe_buf_mode == "shard_map"`` and a mesh whose "model" dim divides E,
each MoE sublayer runs ``moe.moe_ffn_shard_map`` over that mesh (expert
parallel, one all-reduce); otherwise ``moe.moe_ffn``, with ``buf_mode``
"local" in place of "shard_map" as JAX passes it (Mixtral's 8 experts on
the production mesh's model dim of 16). ``cfg.remat`` and
``cfg.remat_policy`` are placed where JAX places its ``jax.checkpoint``: one
``torch.utils.checkpoint`` around each period's body when the forward
carries gradients (``"full"``: everything recomputed in the backward;
``"dots"``: the unbatched matrix products' outputs saved, the rest
recomputed; ``"none"``: plain), never around Whisper's encoder, whose JAX
scan has none.

``forward`` and ``encode`` carry gradients; the parameters are allocated
with ``requires_grad=False`` and ``training.lm_step`` turns gradients on for
what it trains. ``loss`` is JAX's cross-entropy plus 0.01 times the MoE aux
loss. Serving (``decode_step``, ``prefill``, ``make_prefill_step``,
``ServeEngine``) runs under ``torch.no_grad()`` and builds no graph.

Full-sequence attention (``forward``) runs the flash-attention kernel once
per attention sublayer on the card. Decode (``decode_step``) attends with
plain PyTorch against a KV cache that it updates in place, as JAX computes
it with jnp; the MoE FFN and the SSD mixer are plain PyTorch products
(``models/moe.py``, ``models/mamba2.py``), as JAX leaves them to XLA.
Cross-attention calls the flash kernel in the forward and in every decode
step, as JAX calls its ``chunked_attention`` there.

The forward opens ``telemetry.trace.device_span`` at each stage it walks:
``embed`` (the lookup, the positions and the aux's zero), ``attn`` and
``ffn`` around each sublayer in ``_period`` (an encoder-decoder's
cross-attention inside ``attn``, the FFN's aux sum inside ``ffn``), and
``head``; ``norm`` in ``_norm`` and ``_qk_norm``, ``rope`` in ``_rope``.
With no profiler running a site costs one check.

Both frontends are JAX's stubs: Whisper's encoder takes precomputed frame
embeddings (B, S_enc, d) in the model's dtype (``enc_frames``), InternVL's
forward precomputed patch embeddings (B, P, d) that replace the first P
token embeddings (``patch_embeds``).

    lm = LM(get_config("qwen3-8b"))                # bf16 on the card
    lm.init_params(torch.Generator("cuda").manual_seed(0))
    logits, aux = lm.forward(tokens)               # tokens (B, S) on the card
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.lowering import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2, moe
from repro_torch.models.config import ArchConfig
from repro_torch.telemetry import trace

class Leaf(NamedTuple):
    """A parameter's shape, how JAX initialises it (``"normal"`` times
    ``scale``, ``"ones"``, ``"zeros"`` or ``"a_log"``, log(linspace(1, 16,
    H))), and whether it stays float32 in a model of another dtype."""
    shape: tuple[int, ...]
    init: str
    scale: float = 0.02
    float32: bool = False


def _attn_shapes(cfg: ArchConfig, cross: bool = False) -> dict[str, Leaf]:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {"ln": Leaf((d,), "ones"),
         "wq": Leaf((d, hq * dh), "normal"),
         "wk": Leaf((d, hkv * dh), "normal"),
         "wv": Leaf((d, hkv * dh), "normal"),
         "wo": Leaf((hq * dh, d), "normal")}
    if cfg.norm == "layernorm":
        p["ln_b"] = Leaf((d,), "zeros")
    if cfg.qkv_bias:
        p["bq"] = Leaf((hq * dh,), "zeros")
        p["bk"] = Leaf((hkv * dh,), "zeros")
        p["bv"] = Leaf((hkv * dh,), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = Leaf((dh,), "ones")
        p["k_norm"] = Leaf((dh,), "ones")
    if cross:
        p["x_ln"] = Leaf((d,), "ones")
        if cfg.norm == "layernorm":
            p["x_ln_b"] = Leaf((d,), "zeros")
        p["x_wq"] = Leaf((d, hq * dh), "normal")
        p["x_wk"] = Leaf((d, hkv * dh), "normal")
        p["x_wv"] = Leaf((d, hkv * dh), "normal")
        p["x_wo"] = Leaf((hq * dh, d), "normal")
    return p


def _mamba_shapes(cfg: ArchConfig) -> dict[str, Leaf]:
    d, d_in = cfg.d_model, cfg.d_inner
    H, N, G, K = cfg.ssm_heads, cfg.ssm_d_state, cfg.ssm_n_groups, \
        cfg.ssm_conv
    conv_ch = d_in + 2 * G * N
    return {"ln": Leaf((d,), "ones"),
            "in_proj": Leaf((d, 2 * d_in + 2 * G * N + H), "normal"),
            "conv_w": Leaf((K, conv_ch), "normal", scale=0.1),
            "conv_b": Leaf((conv_ch,), "zeros"),
            "A_log": Leaf((H,), "a_log", float32=True),
            "D": Leaf((H,), "ones", float32=True),
            "dt_bias": Leaf((H,), "zeros", float32=True),
            "norm": Leaf((d_in,), "ones"),
            "out_proj": Leaf((d_in, d), "normal")}


def _ffn_shapes(cfg: ArchConfig, idx_in_period: int) -> dict[str, Leaf]:
    d = cfg.d_model
    if cfg.is_moe_layer(idx_in_period):
        E, f = cfg.n_experts, cfg.d_ff_expert
        return {"ln2": Leaf((d,), "ones"),
                "router": Leaf((d, E), "normal", float32=True),
                "w_gate": Leaf((E, d, f), "normal"),
                "w_up": Leaf((E, d, f), "normal"),
                "w_down": Leaf((E, f, d), "normal")}
    if not cfg.d_ff:
        return {}
    if cfg.act == "gelu":
        p = {"ln2": Leaf((d,), "ones"),
             "w_in": Leaf((d, cfg.d_ff), "normal"),
             "b_in": Leaf((cfg.d_ff,), "zeros"),
             "w_out": Leaf((cfg.d_ff, d), "normal"),
             "b_out": Leaf((d,), "zeros")}
        if cfg.norm == "layernorm":
            p["ln2_b"] = Leaf((d,), "zeros")
        return p
    return {"ln2": Leaf((d,), "ones"),
            "w_gate": Leaf((d, cfg.d_ff), "normal"),
            "w_up": Leaf((d, cfg.d_ff), "normal"),
            "w_down": Leaf((cfg.d_ff, d), "normal")}


def _sublayer_shapes(cfg: ArchConfig, i: int, kind: str,
                     cross: bool = False) -> dict[str, Leaf]:
    """Sublayer ``i`` of the period, of ``kind``, as JAX's
    ``_period_params`` builds it (with the cross-attention leaves where
    ``cross``)."""
    if kind == "attn":
        p = _attn_shapes(cfg, cross)
    elif kind == "mamba":
        p = _mamba_shapes(cfg)
    else:
        raise ValueError(kind)
    p.update(_ffn_shapes(cfg, i))
    return p


def _top_shapes(cfg: ArchConfig) -> dict[str, Leaf]:
    p = {"embed": Leaf((cfg.vocab, cfg.d_model), "normal"),
         "final_norm": Leaf((cfg.d_model,), "ones")}
    if cfg.norm == "layernorm":
        p["final_norm_b"] = Leaf((cfg.d_model,), "zeros")
    if not cfg.tie_embeddings:
        p["lm_head"] = Leaf((cfg.d_model, cfg.vocab), "normal")
    if cfg.enc_layers:
        p["enc_final_norm"] = Leaf((cfg.d_model,), "ones")
        p["enc_final_norm_b"] = Leaf((cfg.d_model,), "zeros")
    return p


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The config JAX draws the encoder's layers under: every head its own
    K and V."""
    return dataclasses.replace(cfg, n_kv_heads=cfg.n_heads)


def _save_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy, JAX's ``dots_with_no_batch_dims_saveable``:
    keep the outputs of the matrix products without batch dimensions
    (``aten.mm``: the projections, FFNs and head) for the backward and
    recompute everything else, batched products (attention's scores, the
    experts over E, the SSD) among it."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@functools.lru_cache(maxsize=8)
def _sinusoid_np(S: int, d: int) -> np.ndarray:
    """JAX's sinusoid table (1, S, d) in float64: sin then cos of
    pos / 10000 ** (2i / d). Computed in float32 the table moves by up to
    1.07e-4 at S 1500, d 384, and 1,353 of its bf16 values."""
    pos = np.arange(S)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)[None]


def _sinusoid(S: int, d: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """The float64 table cast to ``dtype`` on the host, as JAX casts it."""
    return torch.from_numpy(_sinusoid_np(S, d)).to(dtype).to(device)


def _noop(x, logical_axes):
    return x


class LM(nn.Module):
    #: the weights ``_gather_weights`` constrains to their TP-only specs
    _WG_IN = ("wq", "wk", "wv", "x_wq", "x_wk", "x_wv", "w_in", "in_proj")
    _WG_OUT = ("wo", "x_wo", "w_down", "w_out", "out_proj")

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda", constrain=None):
        """Allocates the parameters (uninitialised) on ``device`` in
        ``dtype`` (the float32 leaves in float32); ``init_params`` draws
        them, ``convert`` loads JAX's. ``device="meta"`` allocates nothing
        (a full configuration's shapes for the sharding rules).
        ``constrain`` is JAX's sharding callback (None: no constraint); its
        ``mesh`` (a ``DeviceMesh``) steers the MoE sublayers (``_ffn``)."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.constrain = constrain

        def empty(leaf, lead=()):
            return torch.empty(lead + leaf.shape, device=dev,
                               dtype=torch.float32 if leaf.float32 else dtype)

        def stack(tree, key, shapes, n):
            """n ParameterDicts, entry p of each the slice p of one tensor
            per leaf, stacked over the n layers as JAX stacks it."""
            whole = {name: empty(leaf, (n,)) for name, leaf in shapes.items()}
            self.stacked.update({f"{tree}/{key}/{name}": t
                                 for name, t in whole.items()})
            return [nn.ParameterDict({
                name: nn.Parameter(t[p], requires_grad=False)
                for name, t in whole.items()}) for p in range(n)]

        cross = bool(cfg.enc_layers)
        #: JAX's stacked leaves by ``"/"``-joined path, each the storage of
        #: its slices in ``layers`` / ``encoder`` (``models/convert.py``)
        self.stacked: dict[str, torch.Tensor] = {}
        self.top = nn.ParameterDict({
            name: nn.Parameter(empty(leaf), requires_grad=False)
            for name, leaf in _top_shapes(cfg).items()})
        subs = {f"{i}:{kind}": stack("blocks", f"{i}:{kind}",
                                     _sublayer_shapes(cfg, i, kind, cross),
                                     cfg.n_periods)
                for i, kind in enumerate(cfg.period)}
        self.layers = nn.ModuleList(
            nn.ModuleDict({key: s[p] for key, s in subs.items()})
            for p in range(cfg.n_periods))
        enc = stack("enc_blocks", "0:attn", _sublayer_shapes(
            _encoder_cfg(cfg), 0, "attn"), cfg.enc_layers) \
            if cfg.enc_layers else []
        self.encoder = nn.ModuleList(nn.ModuleDict({"0:attn": s})
                                     for s in enc)

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.top["embed"].dtype

    def sublayers(self):
        """(period, index in the period, kind, parameters) of every
        sublayer, in the order the forward runs them."""
        for p, block in enumerate(self.layers):
            for i, kind in enumerate(self.cfg.period):
                yield p, i, kind, block[f"{i}:{kind}"]

    # ================================================================ params
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "LM":
        """Draw every parameter as ``LM.init_params`` does: matrices
        normal(0, 1) times their scale (0.02; 0.1 for the conv) drawn in
        float32 and cast, norms and ``D`` one, biases zero, ``A_log``
        log(linspace(1, 16, H)). ``generator`` lies on the parameters'
        device; the same seed gives the same parameters, but not JAX's
        numbers (``convert`` carries those across)."""
        cfg, cross = self.cfg, bool(self.cfg.enc_layers)
        groups = [(self.top, _top_shapes(cfg))] + [
            (sub, _sublayer_shapes(cfg, i, kind, cross))
            for _, i, kind, sub in self.sublayers()] + [
            (blk["0:attn"], _sublayer_shapes(_encoder_cfg(cfg), 0, "attn"))
            for blk in self.encoder]
        for params, shapes in groups:
            for name, leaf in shapes.items():
                w = params[name]
                if leaf.init == "normal":
                    w.copy_(torch.randn(leaf.shape, generator=generator,
                                        dtype=torch.float32,
                                        device=w.device).mul_(leaf.scale))
                elif leaf.init == "a_log":
                    w.copy_(torch.log(torch.linspace(
                        1.0, 16.0, leaf.shape[0], dtype=torch.float32,
                        device=w.device)))
                else:
                    w.fill_(1.0 if leaf.init == "ones" else 0.0)
        return self

    # =============================================================== helpers
    def _constrain(self, x, logical_axes):
        """JAX's ``self.constrain``: x and the logits, the gathered
        weights."""
        return x if self.constrain is None else \
            self.constrain(x, logical_axes)

    @property
    def constrain_mid(self):
        """JAX's mid-layer callback: ``constrain`` under
        ``cfg.activation_constraints``, else none."""
        if self.constrain is None or not self.cfg.activation_constraints:
            return _noop
        return self.constrain

    def _gather_weights(self, sub):
        """ZeRO-3's weight gather (``cfg.fsdp_weight_gather``): this
        sublayer's matrices constrained to their TP-only specs at use, in
        JAX's order (its scan hands the body each dict with sorted keys).
        Without the knob, ``sub`` itself."""
        if not self.cfg.fsdp_weight_gather:
            return sub
        out = {}
        for k in sorted(sub):
            v = sub[k]
            if k in self._WG_IN and v.ndim == 2:
                v = self._constrain(v, (None, ("model", None)))
            elif k in self._WG_OUT and v.ndim == 2:
                v = self._constrain(v, (("model", None), None))
            elif k in ("w_gate", "w_up"):
                v = self._constrain(v, (("model", None), None,
                                        ("model", None)) if v.ndim == 3
                                    else (None, ("model", None)))
            elif k == "w_down" and v.ndim == 3:
                v = self._constrain(v, (("model", None), ("model", None),
                                        None))
            out[k] = v
        return out

    def _norm(self, x, p, name="ln"):
        with trace.device_span("norm"):
            if self.cfg.norm == "layernorm":
                return L.layernorm(x, p[name], p[f"{name}_b"],
                                   self.cfg.norm_eps)
            return L.rmsnorm(x, p[name], self.cfg.norm_eps)

    def _residual(self, x, y):
        """x plus a sublayer's output y, the product of its row-parallel
        projection (``wo``, ``x_wo``, ``w_down``, ``w_out``, ``out_proj``)
        or its MoE FFN: where a sharded y's partial sums are reduced."""
        return x + y

    def _carry(self, x):
        """x as it enters a period: the scan carry JAX's program saves for
        the period's rematerialised backward."""
        return x

    def _proj(self, h, w, heads=None):
        """h @ w, a column-parallel product (``wq``, ``wk``, ``wv``,
        ``x_wq``, ``x_wk``, ``x_wv``, the head), whose columns split into
        ``heads`` heads (None: any split)."""
        return h @ w

    def _out(self, t, w):
        """t @ w, a row-parallel product (``wo``, ``x_wo``), whose partial
        sums ``_residual`` reduces where t's columns are sharded."""
        return t @ w

    def _split_heads(self, t, heads):
        """(B, S, heads * d_head) -> (B, S, heads, d_head)."""
        return t.reshape(t.shape[0], t.shape[1], heads, self.cfg.d_head)

    def _merge_heads(self, t):
        """An attention output (B, heads, S, d_head) -> (B, S, heads *
        d_head), the row-parallel projection's input."""
        return t.movedim(1, 2).reshape(t.shape[0], t.shape[2], -1)

    def _qkv(self, h, p):
        c = self.cfg
        q = self._proj(h, p["wq"], c.n_heads)
        k = self._proj(h, p["wk"], c.n_kv_heads)
        v = self._proj(h, p["wv"], c.n_kv_heads)
        if c.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = self._split_heads(q, c.n_heads)
        k = self._split_heads(k, c.n_kv_heads)
        v = self._split_heads(v, c.n_kv_heads)
        if c.qk_norm:
            q = self._qk_norm(q, p["q_norm"])
            k = self._qk_norm(k, p["k_norm"])
        return q, k, v

    def _qk_norm(self, t, scale):
        """The per-head RMS norm of q or k (B, S, heads, d_head) with its
        (d_head,) scale."""
        with trace.device_span("norm"):
            return L.rmsnorm(t, scale, self.cfg.norm_eps)

    def _rope(self, q, k, positions):
        theta = self.cfg.rope_theta
        if theta > 0:
            with trace.device_span("rope"):
                q = L.apply_rope(q, positions, theta)
                k = L.apply_rope(k, positions, theta)
        return q, k

    def _attn_full(self, x, p, positions, causal=True):
        """Prefill attention over the whole sequence: the flash kernel reads
        the (B, S, H, D) projections through (B, H, S, D) views."""
        h = self._norm(x, p)
        q, k, v = self._qkv(h, p)
        q, k = self._rope(q, k, positions)
        sp = ("data", None, "model", None)
        q = self.constrain_mid(q, sp)
        k = self.constrain_mid(k, sp)
        out = L.chunked_attention(q.movedim(1, 2), k.movedim(1, 2),
                                  v.movedim(1, 2), causal=causal,
                                  window=self.cfg.attn_window)
        return self._residual(x, self._out(self._merge_heads(out), p["wo"]))

    def _cross_kv(self, enc_out, p):
        """The keys and values sublayer ``p`` attends to over the encoder's
        output: (B, Hkv, S_enc, D) views of its (B, S_enc, Hkv, D)
        projections, the forward's cross-attention inputs and what a filled
        decode cache holds as ``xk``, ``xv``."""
        c = self.cfg
        k = self._split_heads(self._proj(enc_out, p["x_wk"], c.n_kv_heads),
                              c.n_kv_heads)
        v = self._split_heads(self._proj(enc_out, p["x_wv"], c.n_kv_heads),
                              c.n_kv_heads)
        return k.movedim(1, 2), v.movedim(1, 2)

    def _cross_attn(self, x, p, k, v):
        """Non-causal attention of x's queries over ``k``, ``v`` (B, Hkv,
        S_enc, D) with the sublayer's ``x_*`` leaves; no qkv bias and no
        qk-norm, as JAX's ``_cross_attn`` has none."""
        c = self.cfg
        h = self._norm(x, p, "x_ln")
        q = self._split_heads(self._proj(h, p["x_wq"], c.n_heads), c.n_heads)
        out = L.chunked_attention(q.movedim(1, 2), k, v, causal=False)
        return self._residual(x, self._out(self._merge_heads(out), p["x_wo"]))

    def _ffn(self, x, p, idx_in_period):
        """-> (x + the FFN's output, its aux loss, float32). A MoE sublayer
        runs ``moe_ffn_shard_map`` where the config asks for it and the
        mesh has a "model" dim that divides E, else ``moe_ffn``, as JAX's
        ``_ffn`` guards it."""
        c = self.cfg
        if c.is_moe_layer(idx_in_period):
            h = self._norm(x, p, "ln2")
            mesh = getattr(self.constrain, "mesh", None)
            names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
            if (c.moe_buf_mode == "shard_map" and "model" in names
                    and c.n_experts % mesh.size(names.index("model")) == 0):
                y, aux = moe.moe_ffn_shard_map(
                    h, p, n_experts=c.n_experts, top_k=c.top_k,
                    capacity_factor=c.capacity_factor, mesh=mesh)
            else:
                bm = "local" if c.moe_buf_mode == "shard_map" \
                    else c.moe_buf_mode
                y, aux = moe.moe_ffn(h, p, n_experts=c.n_experts,
                                     top_k=c.top_k,
                                     capacity_factor=c.capacity_factor,
                                     constrain=self.constrain_mid,
                                     buf_mode=bm)
            return self._residual(x, y), aux
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if "ln2" not in p:
            return x, zero
        h = self._norm(x, p, "ln2")
        if c.act == "gelu":
            return self._residual(x, L.gelu_mlp(
                h, p["w_in"], p["b_in"], p["w_out"], p["b_out"])), zero
        h = self.constrain_mid(h, ("data", None, None))
        return self._residual(x, L.swiglu(h, p["w_gate"], p["w_up"],
                                          p["w_down"])), zero

    def _head(self, x):
        top = self.top
        x = self._norm(x, {"ln": top["final_norm"],
                           "ln_b": top["final_norm_b"]
                           if "final_norm_b" in top else None})
        head = top["embed"].T if self.cfg.tie_embeddings else top["lm_head"]
        return self._proj(x, head)

    # ================================================================ forward
    def _lookup(self, tokens):
        """The rows of ``embed`` the tokens name."""
        return F.embedding(tokens.long(), self.top["embed"])

    def _embed(self, tokens, patch_embeds=None):
        """Token embeddings, the first P positions replaced by the patch
        embeddings (B, P, d) cast to the model's dtype: a splice, the
        sequence keeps its length S. ``F.embedding``, not indexing: its
        backward sums repeated tokens' gradients in a fixed order (indexing's
        accumulating scatter does not, on the CPU), which a resumed run
        needs to repeat an uninterrupted one bit for bit."""
        x = self._lookup(tokens)
        if patch_embeds is not None:
            P = patch_embeds.shape[1]
            x = torch.cat([patch_embeds.to(x.dtype), x[:, P:]], dim=1)
        return x

    def _period(self, block, x, aux, positions, enc_out):
        """One period's sublayers on x -> (x, aux + their aux losses)."""
        for i, kind in enumerate(self.cfg.period):
            p = self._gather_weights(block[f"{i}:{kind}"])
            if kind == "attn":
                with trace.device_span("attn"):
                    x = self._attn_full(x, p, positions)
                    if enc_out is not None:
                        x = self._cross_attn(x, p,
                                             *self._cross_kv(enc_out, p))
            else:
                x = self._residual(x, mamba2.mamba2_mixer(
                    self._norm(x, p), p, self.cfg, self.constrain_mid))
            with trace.device_span("ffn"):
                x, a = self._ffn(x, p, i)
                aux = aux + a
        return x, aux

    def _remat(self, body):
        """``body`` under the config's rematerialisation, as JAX wraps its
        scan body: only where the forward carries gradients."""
        c = self.cfg
        if not torch.is_grad_enabled() or not c.remat or \
                c.remat_policy == "none":
            return body
        if c.remat_policy == "dots":
            return functools.partial(
                checkpoint, body, use_reentrant=False,
                context_fn=functools.partial(
                    create_selective_checkpoint_contexts, _save_products))
        return functools.partial(checkpoint, body, use_reentrant=False)

    def forward(self, tokens: torch.Tensor, *, patch_embeds=None,
                enc_frames=None):
        """Training and prefill forward: tokens (B, S) on the model's device
        -> (logits (B, S, V), aux loss), aux the float32 sum of the MoE
        sublayers' load-balance losses (zero without experts). An
        encoder-decoder encodes ``enc_frames`` once and each decoder
        sublayer runs self-attention, cross-attention over the encoder's
        output, then its FFN."""
        with trace.device_span("embed"):
            x = self._constrain(self._embed(tokens, patch_embeds),
                                ("data", None, None))
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        enc_out = self.encode(enc_frames) if self.cfg.enc_layers else None
        period = self._remat(self._period)
        for block in self.layers:
            x = self._carry(x)
            x, aux = period(block, x, aux, positions, enc_out)
        with trace.device_span("head"):
            logits = self._constrain(self._head(x), ("data", None, "model"))
        return logits, aux

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: ``tokens`` (B, S), ``labels`` (B, S) (-100 is masked),
        optional ``patch_embeds`` / ``enc_frames`` -> (total, metrics), JAX's
        arithmetic: the log-sum-exp of float32 logits less the gold logit
        gathered in the logits' dtype, averaged over the unmasked labels
        (at least 1), plus 0.01 times the aux loss; metrics ``ce``, ``aux``
        and ``tokens`` (float32)."""
        logits, aux = self.forward(batch["tokens"],
                                   patch_embeds=batch.get("patch_embeds"),
                                   enc_frames=batch.get("enc_frames"))
        labels = batch["labels"].long()
        mask = labels >= 0
        nll = self._nll(logits, labels.clamp_min(0))
        denom = mask.sum().clamp_min(1)
        ce = torch.where(mask, nll, 0.0).sum() / denom
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux, "tokens": denom.float()}

    def _store(self, cache, slot, new):
        """A decode step's K or V, new (B, Hkv, D), written into its cache
        (B, Hkv, S, D) at position ``slot``, in place."""
        cache[:, :, slot] = new

    def _nll(self, logits, labels):
        """Each position's negative log-likelihood, float32: the
        log-sum-exp of float32 logits less the gold logit gathered in the
        logits' dtype. ``labels`` are in [0, V)."""
        lse = torch.logsumexp(logits.float(), dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return lse - gold.float()

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder: frames (B, S, d) in the model's dtype ->
        (B, S, d). The frames plus JAX's sinusoid table, then each layer's
        non-causal self-attention and GELU FFN, then the layernorm
        ``enc_final_norm``. JAX runs the encoder's attention under the
        decoder's config; Whisper's ``n_kv_heads`` equals ``n_heads``, so
        that reads the encoder's own K and V heads. Frames of another
        dtype are refused, never cast (JAX would promote them)."""
        if frames.dtype != self.dtype:
            raise ValueError(f"enc_frames are {frames.dtype}, the model "
                             f"{self.dtype}: pass frames in the model's dtype")
        B, S, _ = frames.shape
        x = frames + _sinusoid(S, self.cfg.d_model, frames.dtype,
                               frames.device)
        pos = torch.arange(S, device=x.device)[None, :]
        for blk in self.encoder:
            p = blk["0:attn"]
            x = self._attn_full(x, p, pos, causal=False)
            x, _ = self._ffn(x, p, 0)
        return L.layernorm(x, self.top["enc_final_norm"],
                           self.top["enc_final_norm_b"])

    # ================================================================= cache
    def init_cache(self, B: int, s_max: int,
                   enc_len: int | None = None) -> dict:
        """An empty decode cache, JAX's layout: for each sublayer
        ``blocks["{i}:{kind}"]`` holds, over the n_periods periods, an
        attention sublayer's ``"k"`` and ``"v"`` (n_periods, B, Hkv, s_kv,
        D) in the parameters' dtype, s_kv = min(s_max, window) under a
        sliding window, and a mamba sublayer's ``"state"`` (n_periods, B, H,
        N, P) in float32 and ``"conv"`` (n_periods, B, K-1, conv_ch) in the
        parameters' dtype; ``len`` is the tokens seen (a host int). An
        encoder-decoder's attention sublayers also hold the cross keys and
        values ``"xk"``, ``"xv"`` (n_periods, B, Hkv, enc_len or
        cross_len, D), zeros as JAX's are: nothing here or in JAX fills
        them from an encoder."""
        c = self.cfg
        s_kv = min(s_max, c.attn_window) if c.attn_window else s_max

        def zeros(*shape, dtype=self.dtype):
            return torch.zeros((c.n_periods, B) + shape, dtype=dtype,
                               device=self.device)

        blocks = {}
        for i, kind in enumerate(c.period):
            if kind == "attn":
                entry = {"k": zeros(c.n_kv_heads, s_kv, c.d_head),
                         "v": zeros(c.n_kv_heads, s_kv, c.d_head)}
                if c.enc_layers:
                    el = enc_len or c.cross_len
                    entry["xk"] = zeros(c.n_kv_heads, el, c.d_head)
                    entry["xv"] = zeros(c.n_kv_heads, el, c.d_head)
            else:
                conv_ch = c.d_inner + 2 * c.ssm_n_groups * c.ssm_d_state
                entry = {"state": zeros(c.ssm_heads, c.ssm_d_state,
                                        c.ssm_head_dim, dtype=torch.float32),
                         "conv": zeros(c.ssm_conv - 1, conv_ch)}
            blocks[f"{i}:{kind}"] = entry
        return {"blocks": blocks, "len": 0}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, 1, V), cache). One new token at
        position ``cache["len"]`` for every row; its K and V, and each mamba
        sublayer's new state and conv window, are written into the cache in
        place (JAX returns a new cache), and the returned cache is the same
        tensors with ``len`` one higher. An encoder-decoder's sublayers
        attend to the cache's ``xk``, ``xv`` after self-attention, through
        the flash kernel, and leave them as they are."""
        c = self.cfg
        B = tokens.shape[0]
        pos = int(cache["len"])
        x = self._embed(tokens)
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        blocks = cache["blocks"]
        for n, i, kind, p in self.sublayers():
            p = self._gather_weights(p)
            pc = blocks[f"{i}:{kind}"]
            h = self._norm(x, p)
            if kind == "attn":
                q, k, v = self._qkv(h, p)
                q, k = self._rope(q, k, positions)
                kc, vc = pc["k"][n], pc["v"][n]
                s_kv = kc.shape[2]
                rotated = c.attn_window is not None and s_kv == c.attn_window
                slot = pos % s_kv if rotated else min(pos, s_kv - 1)
                self._store(kc, slot, k[:, 0])
                self._store(vc, slot, v[:, 0])
                out = L.decode_attention(q.movedim(1, 2), kc, vc,
                                         cache_len=min(pos + 1, s_kv),
                                         window=c.attn_window,
                                         window_rotated=rotated)
                x = self._residual(x, self._out(self._merge_heads(out),
                                                p["wo"]))
                if c.enc_layers:
                    x = self._cross_attn(x, p, pc["xk"][n], pc["xv"][n])
            else:
                st = mamba2.SSMState(state=pc["state"][n], conv=pc["conv"][n])
                y, st = mamba2.mamba2_decode_step(h, p, c, st)
                x = self._residual(x, y)
                pc["state"][n] = st.state
                pc["conv"][n] = st.conv
            x, _ = self._ffn(x, p, i)
        return self._head(x), {"blocks": blocks, "len": pos + 1}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, s_max: int,
                enc_len: int | None = None):
        """The decode cache built token by token through ``decode_step``
        (JAX's test-scale path) -> (last logits (B, 1, V), cache)."""
        cache = self.init_cache(tokens.shape[0], s_max, enc_len=enc_len)
        logits = None
        for t in range(tokens.shape[1]):
            logits, cache = self.decode_step(cache, tokens[:, t:t + 1])
        return logits, cache

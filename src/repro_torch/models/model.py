"""The LM zoo's model, dense family: one forward / prefill / decode.

The port of ``repro.models.model.LM`` for the configurations whose period is
one attention sublayer with a dense FFN (Qwen3, Qwen2.5, Yi, Mistral-Nemo).
``LM`` is an ``nn.Module`` holding its parameters under JAX's names, one
``nn.ParameterDict`` per layer (JAX stacks them over ``n_periods`` under
``blocks["0:attn"]``); weight matrices keep JAX's ``x @ w`` orientation,
(in, out), so a JAX parameter tree loads without a transpose
(``models/convert.py``). What JAX's ``constrain`` callbacks, ``remat`` and
``attn_gqa_mode`` steer (sharding and memory under XLA) has no counterpart
here and changes no result.

Full-sequence attention (``forward``) runs the flash-attention kernel once
per layer on the card. Decode (``decode_step``) attends with plain PyTorch
against a KV cache that it updates in place, as JAX computes it with jnp.
The other families raise ``NotImplementedError`` naming their ROADMAP item.

    lm = LM(get_config("qwen3-8b"))                # bf16 on the card
    lm.init_params(torch.Generator("cuda").manual_seed(0))
    logits, aux = lm.forward(tokens)               # tokens (B, S) on the card
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.lowering import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

#: the ROADMAP §1 item that ports each family the port does not run yet
_WAITING = {
    "moe": "item 6 (MoE, models/moe.py)",
    "ssm": "item 7 (Mamba2/SSD, models/mamba2.py)",
    "hybrid": "items 6 and 7 (MoE and Mamba2/SSD: Jamba)",
    "audio": "item 8 (Whisper)",
    "vlm": "item 9 (InternVL)",
}


def check_dense(cfg: ArchConfig) -> None:
    """Raise unless the port runs ``cfg``: the dense family (one attention
    sublayer per period, a dense FFN, no encoder and no frontend)."""
    if cfg.family != "dense" or cfg.period != ("attn",) or cfg.n_experts \
            or cfg.enc_layers or cfg.frontend:
        item = _WAITING.get(cfg.family, "§1")
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense LM family only; the "
            f"{cfg.family} family waits for ROADMAP §1 {item}")


def _layer_shapes(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """name -> (shape, how JAX initialises it: "normal", "ones", "zeros")."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {"ln": ((d,), "ones"),
         "wq": ((d, hq * dh), "normal"),
         "wk": ((d, hkv * dh), "normal"),
         "wv": ((d, hkv * dh), "normal"),
         "wo": ((hq * dh, d), "normal")}
    if cfg.norm == "layernorm":
        p["ln_b"] = ((d,), "zeros")
    if cfg.qkv_bias:
        p["bq"] = ((hq * dh,), "zeros")
        p["bk"] = ((hkv * dh,), "zeros")
        p["bv"] = ((hkv * dh,), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = ((dh,), "ones")
        p["k_norm"] = ((dh,), "ones")
    if cfg.d_ff and cfg.act == "gelu":
        p.update({"ln2": ((d,), "ones"),
                  "w_in": ((d, cfg.d_ff), "normal"),
                  "b_in": ((cfg.d_ff,), "zeros"),
                  "w_out": ((cfg.d_ff, d), "normal"),
                  "b_out": ((d,), "zeros")})
        if cfg.norm == "layernorm":
            p["ln2_b"] = ((d,), "zeros")
    elif cfg.d_ff:
        p.update({"ln2": ((d,), "ones"),
                  "w_gate": ((d, cfg.d_ff), "normal"),
                  "w_up": ((d, cfg.d_ff), "normal"),
                  "w_down": ((cfg.d_ff, d), "normal")})
    return p


def _top_shapes(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    p = {"embed": ((cfg.vocab, cfg.d_model), "normal"),
         "final_norm": ((cfg.d_model,), "ones")}
    if cfg.norm == "layernorm":
        p["final_norm_b"] = ((cfg.d_model,), "zeros")
    if not cfg.tie_embeddings:
        p["lm_head"] = ((cfg.d_model, cfg.vocab), "normal")
    return p


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        """Allocates the parameters (uninitialised) on ``device`` in
        ``dtype``; ``init_params`` draws them, ``convert`` loads JAX's."""
        super().__init__()
        check_dense(cfg)
        dev = resolve_device(device)
        self.cfg = cfg

        def alloc(shapes):
            return nn.ParameterDict({
                name: nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                                   requires_grad=False)
                for name, (shape, _) in shapes.items()})

        self.top = alloc(_top_shapes(cfg))
        self.layers = nn.ModuleList(alloc(_layer_shapes(cfg))
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.top["embed"].dtype

    # ================================================================ params
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "LM":
        """Draw every parameter as ``LM.init_params`` does: matrices
        normal(0, 1) * 0.02 drawn in float32 and cast, norms one, biases
        zero. ``generator`` lies on the parameters' device; the same seed
        gives the same parameters, but not JAX's numbers (``convert`` carries
        those across)."""
        groups = [(self.top, _top_shapes(self.cfg))] + [
            (p, _layer_shapes(self.cfg)) for p in self.layers]
        for params, shapes in groups:
            for name, (shape, how) in shapes.items():
                w = params[name]
                if how == "normal":
                    w.copy_(torch.randn(shape, generator=generator,
                                        dtype=torch.float32,
                                        device=w.device).mul_(0.02))
                else:
                    w.fill_(1.0 if how == "ones" else 0.0)
        return self

    # =============================================================== helpers
    def _norm(self, x, p, name="ln"):
        if self.cfg.norm == "layernorm":
            return L.layernorm(x, p[name], p[f"{name}_b"], self.cfg.norm_eps)
        return L.rmsnorm(x, p[name], self.cfg.norm_eps)

    def _qkv(self, h, p):
        c = self.cfg
        q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
        if c.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        B, S = h.shape[:2]
        q = q.reshape(B, S, c.n_heads, c.d_head)
        k = k.reshape(B, S, c.n_kv_heads, c.d_head)
        v = v.reshape(B, S, c.n_kv_heads, c.d_head)
        if c.qk_norm:
            q = L.rmsnorm(q, p["q_norm"], c.norm_eps)
            k = L.rmsnorm(k, p["k_norm"], c.norm_eps)
        return q, k, v

    def _rope(self, q, k, positions):
        theta = self.cfg.rope_theta
        if theta > 0:
            q = L.apply_rope(q, positions, theta)
            k = L.apply_rope(k, positions, theta)
        return q, k

    def _attn_full(self, x, p, positions):
        """Prefill attention over the whole sequence: the flash kernel reads
        the (B, S, H, D) projections through (B, H, S, D) views."""
        h = self._norm(x, p)
        q, k, v = self._qkv(h, p)
        q, k = self._rope(q, k, positions)
        out = L.chunked_attention(q.movedim(1, 2), k.movedim(1, 2),
                                  v.movedim(1, 2), causal=True,
                                  window=self.cfg.attn_window)
        out = out.movedim(1, 2).reshape(x.shape[0], x.shape[1], -1)
        return x + out @ p["wo"]

    def _ffn(self, x, p):
        if "ln2" not in p:
            return x
        h = self._norm(x, p, "ln2")
        if self.cfg.act == "gelu":
            return x + L.gelu_mlp(h, p["w_in"], p["b_in"], p["w_out"],
                                  p["b_out"])
        return x + L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])

    def _head(self, x):
        top = self.top
        x = self._norm(x, {"ln": top["final_norm"],
                           "ln_b": top["final_norm_b"]
                           if "final_norm_b" in top else None})
        head = top["embed"].T if self.cfg.tie_embeddings else top["lm_head"]
        return x @ head

    # ================================================================ forward
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor):
        """Prefill forward: tokens (B, S) on the model's device ->
        (logits (B, S, V), aux loss), aux a float32 zero (no experts)."""
        x = self.top["embed"][tokens.long()]
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for p in self.layers:
            x = self._ffn(self._attn_full(x, p, positions), p)
        return self._head(x), torch.zeros((), dtype=torch.float32,
                                          device=x.device)

    # ================================================================= cache
    def init_cache(self, B: int, s_max: int) -> dict:
        """An empty KV cache in the parameters' dtype, JAX's layout:
        ``blocks["0:attn"]["k"|"v"]`` of (n_layers, B, Hkv, s_kv, D), s_kv =
        min(s_max, window) under a sliding window, and ``len``, the tokens
        seen (a host int)."""
        c = self.cfg
        s_kv = min(s_max, c.attn_window) if c.attn_window else s_max
        shape = (c.n_layers, B, c.n_kv_heads, s_kv, c.d_head)
        return {"blocks": {"0:attn": {
                    "k": torch.zeros(shape, dtype=self.dtype,
                                     device=self.device),
                    "v": torch.zeros(shape, dtype=self.dtype,
                                     device=self.device)}},
                "len": 0}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, 1, V), cache). One new token at
        position ``cache["len"]`` for every row; its K and V are written into
        the cache in place (JAX returns a new cache), and the returned cache
        is the same tensors with ``len`` one higher."""
        c = self.cfg
        B = tokens.shape[0]
        pos = int(cache["len"])
        x = self.top["embed"][tokens.long()]
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        kc_all = cache["blocks"]["0:attn"]["k"]
        vc_all = cache["blocks"]["0:attn"]["v"]
        s_kv = kc_all.shape[3]
        rotated = c.attn_window is not None and s_kv == c.attn_window
        slot = pos % s_kv if rotated else min(pos, s_kv - 1)
        cache_len = min(pos + 1, s_kv)
        for i, p in enumerate(self.layers):
            h = self._norm(x, p)
            q, k, v = self._qkv(h, p)
            q, k = self._rope(q, k, positions)
            kc, vc = kc_all[i], vc_all[i]
            kc[:, :, slot] = k[:, 0]
            vc[:, :, slot] = v[:, 0]
            out = L.decode_attention(q.movedim(1, 2), kc, vc,
                                     cache_len=cache_len,
                                     window=c.attn_window,
                                     window_rotated=rotated)
            x = x + out.movedim(1, 2).reshape(B, 1, -1) @ p["wo"]
            x = self._ffn(x, p)
        return self._head(x), {"blocks": cache["blocks"], "len": pos + 1}

    def prefill(self, tokens: torch.Tensor, s_max: int):
        """The decode cache built token by token through ``decode_step``
        (JAX's test-scale path) -> (last logits (B, 1, V), cache)."""
        cache = self.init_cache(tokens.shape[0], s_max)
        logits = None
        for t in range(tokens.shape[1]):
            logits, cache = self.decode_step(cache, tokens[:, t:t + 1])
        return logits, cache

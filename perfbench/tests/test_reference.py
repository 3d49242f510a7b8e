"""The plain reference against the port's LM at reduced sizes on the CPU,
both in float32 on the benchmark's weights: the forward (the prefill
path, capacity drops and a sliding window included) and the token-by-token
decode through the cache."""

from __future__ import annotations

import copy

import pytest
import torch

from conftest import TINY_DENSE, TINY_MOE
from perfbench import model
from perfbench import weights as W
from perfbench.reference import decoder as R

SEED = 2 ** 33 + 17


def _f32(cfg: dict) -> dict:
    return {**copy.deepcopy(cfg), "torch_dtype": "float32"}


@pytest.mark.parametrize("cfg", [TINY_DENSE, TINY_MOE],
                         ids=["qwen3", "mixtral"])
def test_forward_matches_the_port(cfg):
    cfg = _f32(cfg)
    lm = model.build(cfg, SEED, "cpu")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 40), generator=g)
    with torch.no_grad():
        got, _ = lm.forward(tokens)
    w = W.Weights(cfg, SEED, "cpu", torch.float32)
    want = R.logits(w.top("lm_head"), R.hidden(cfg, w, tokens, block=16))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), \
        float((got - want).abs().max())


def test_capacity_drops_are_the_ports():
    """At S 40, k 2, E 4 each expert takes at most 24 of a row's 80
    assignments: some drop, and the reference drops the same ones."""
    cfg = _f32(TINY_MOE)
    w = W.Weights(cfg, SEED, "cpu", torch.float32)
    h = torch.randn(2, 40, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    _, e, kept = R.route(h, w.layer(0)["router"], 2, 1.0)
    assert not kept.all()
    from repro_torch.models import moe
    r = moe.route(h, w.layer(0)["router"], n_experts=4, top_k=2,
                  capacity_factor=1.0)
    assert torch.equal(r.top_i, e)
    assert torch.equal(r.keep.reshape(kept.shape), kept)


@pytest.mark.parametrize("cfg", [TINY_DENSE, TINY_MOE],
                         ids=["qwen3", "mixtral"])
def test_decode_matches_the_full_forward(cfg):
    """The port's ``decode_step``, one token at a time through its cache,
    against the reference's full forward without capacity."""
    cfg = _f32(cfg)
    lm = model.build(cfg, SEED, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (3, 30),
                           generator=torch.Generator().manual_seed(5))
    cache = lm.init_cache(3, 32)
    steps = []
    for t in range(tokens.shape[1]):
        out, cache = lm.decode_step(cache, tokens[:, t:t + 1])
        steps.append(out[:, 0])
    got = torch.stack(steps, dim=1)
    w = W.Weights(cfg, SEED, "cpu", torch.float32)
    want = R.logits(w.top("lm_head"),
                    R.hidden(cfg, w, tokens, capacity=False, block=8))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), \
        float((got - want).abs().max())


def test_a_leaf_drawn_into_storage_is_the_leaf_drawn_fresh():
    leaf = W.Leaf("layers.wq", (3, 8, 16), "matrix")
    big = torch.zeros(5, 8, 16, dtype=torch.bfloat16)
    W.draw(leaf, SEED, device="cpu", dtype=torch.bfloat16, out=big[1:4])
    fresh = W.draw(leaf, SEED, device="cpu", dtype=torch.bfloat16)
    assert torch.equal(big[1:4], fresh)
    other = W.draw(leaf, SEED + 1, device="cpu", dtype=torch.bfloat16)
    assert not torch.equal(other, fresh)


def test_the_port_holds_exactly_the_benchmarks_leaves():
    for cfg in (TINY_DENSE, TINY_MOE):
        lm = model.build(cfg, SEED, "cpu")
        for lf in W.leaves(cfg):
            assert tuple(model.lm_leaf(lm, lf.name).shape) == lf.shape

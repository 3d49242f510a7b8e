"""The port's analytic count and roofline (``repro_torch.distributed.
analytic`` and ``roofline``) against the JAX package's, and the H100 record
they read (``repro_torch.core.hw.H100``).

``analytic.estimate`` must equal JAX's for every arch, shape cell and chip
count. JAX's ``roofline.analyze`` reads the TPU's rates and parses
collective bytes out of HLO text; the port's takes the rates as ``hw`` and
the bytes by kind as ``coll_by_kind``, so given JAX's TPU rates and JAX's
parsed bytes of ``tests/test_roofline.py``'s HLO it must give JAX's
``Roofline`` field for field."""

import dataclasses

import pytest

from repro.configs.registry import ALIASES, get_config as jget
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core.hw import TPU_V5E
from repro.distributed import analytic as JAN
from repro.distributed import hloparse as HP
from repro.distributed import roofline as JRL
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.core import hw
from repro_torch.distributed import analytic as AN
from repro_torch.distributed import roofline as RL

ARCHS = list(ALIASES)
CHIPS = (1, 256, 512)
#: JAX's three rates in the port's record
TPU_RATES = dataclasses.replace(
    hw.H100, name="tpu-v5e", peak_bf16_flops=TPU_V5E.peak_bf16_flops,
    hbm_bandwidth=TPU_V5E.hbm_bandwidth,
    link_bandwidth=TPU_V5E.ici_link_bandwidth)

HLO = """\
HloModule jit_f, is_scheduled=true

%add.clone (x: f32[], y: f32[]) -> f32[] {
  ROOT %add = f32[] add(%x, %y)
}

%cond (arg: (s32[], f32[4,16])) -> pred[] {
  %c = s32[] constant(5)
  %i = s32[] get-tuple-element(%arg), index=0
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}

%body (arg: (s32[], f32[4,16])) -> (s32[], f32[4,16]) {
  %x = f32[4,16]{1,0} get-tuple-element(%arg), index=1
  %ar = f32[4,16]{1,0} all-reduce(%x), replica_groups={}, to_apply=%add.clone
  %ag = f32[8,16]{1,0} all-gather(%ar), dimensions={0}
  ROOT %t = (s32[], f32[4,16]) tuple(%i2, %ar)
}

ENTRY %main (p: f32[4,16]) -> f32[4,16] {
  %ag0 = f32[16,16]{1,0} all-gather(%p), dimensions={0}
  %w = (s32[], f32[4,16]) while(%t0), condition=%cond, body=%body
  ROOT %r = f32[4,16]{1,0} get-tuple-element(%w), index=1
}
"""


def test_shape_cells_are_jax_s():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_estimate_equals_jax(arch):
    for name in SHAPES:
        for chips in CHIPS:
            assert AN.estimate(get_config(arch), SHAPES[name], chips) == \
                JAN.estimate(jget(arch), JSHAPES[name], chips), \
                (arch, name, chips)


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_equals_jax_on_jax_s_rates(arch):
    """Field for field, with the collective bytes JAX parses out of the
    HLO handed to the port."""
    coll = HP.collective_bytes_scaled(HLO)
    cost = {"flops": 1.5e12, "bytes accessed": 2.5e9}
    for name in SHAPES:
        for chips in CHIPS:
            kw = dict(arch=arch, shape=name, mesh_name="16x16", chips=chips,
                      cost=cost)
            want = JRL.analyze(hlo_text=HLO, cfg=jget(arch),
                               cell=JSHAPES[name], **kw)
            got = RL.analyze(coll_by_kind=coll, cfg=get_config(arch),
                             cell=SHAPES[name], hw=TPU_RATES, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.row() == want.row()


def test_wire_bytes_equal_jax():
    coll = HP.collective_bytes_scaled(HLO)
    assert RL.wire_bytes(coll) == HP.wire_bytes(coll) == \
        (1024 + 5 * 512) + 2 * 5 * 256
    assert RL.wire_bytes({"all-to-all": 3.0, "reduce-scatter": 4.0}) == 7.0


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax(arch):
    for name in SHAPES:
        assert RL.model_flops(get_config(arch), SHAPES[name]) == \
            JRL.model_flops(jget(arch), JSHAPES[name])


def test_the_h100_record():
    """The datasheet's dense BF16 rate, HBM3 rate and size and NVLink 4's
    rate per direction; nothing of the TPU's."""
    h = hw.H100
    assert (h.peak_bf16_flops, h.hbm_bandwidth, h.link_bandwidth) == \
        (989e12, 3.35e12, 450e9)
    assert h.hbm_bytes == 80 * 2**30
    assert not any(f.name.startswith(("pj_", "ici_", "vmem"))
                   for f in dataclasses.fields(h))
    with pytest.raises(dataclasses.FrozenInstanceError):
        h.peak_bf16_flops = 1.0


def test_one_card_has_no_collective_term_and_reads_the_h100():
    """Qwen3-8B's prefill of 2 x 4,096 at its 36 layers on one card: the
    compute term is the FLOP count over 989 TFLOP/s (about 136 ms), the
    memory term the bytes over 3.35 TB/s, no collective."""
    cfg = get_config("qwen3-8b")
    cell = ShapeCell("prefill_2x4096", 4096, 2, "prefill")
    r = RL.analyze(arch=cfg.name, shape=cell.name, mesh_name="1", chips=1,
                   cfg=cfg, cell=cell)
    est = AN.estimate(cfg, cell, 1)
    assert r.collective_s == 0.0 and r.coll_by_kind == {}
    assert r.compute_s == est["flops_per_chip"] / 989e12
    assert r.memory_s == est["bytes_per_chip"] / 3.35e12
    assert r.bottleneck == "compute" and r.step_s == r.compute_s
    assert 0.13 < r.compute_s < 0.14


def test_decode_is_memory_bound_and_a_window_caps_attention():
    """JAX's two sanity checks of the count, on the card's rates."""
    r = RL.analyze(arch="yi-6b", shape="decode_32k", mesh_name="16x16",
                   chips=256, cfg=get_config("yi-6b"),
                   cell=SHAPES["decode_32k"])
    assert r.memory_s > r.compute_s
    cfg = get_config("mixtral-8x7b")
    full = dataclasses.replace(cfg, attn_window=None)
    assert AN._attn_flops(cfg, SHAPES["prefill_32k"]) < \
        AN._attn_flops(full, SHAPES["prefill_32k"]) / 3
